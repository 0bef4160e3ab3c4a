"""Structure-from-motion layer of the port: dense stereo."""

from icepy4d_tpu_torch.sfm.dense import PlaneSweepStereo  # noqa: F401
