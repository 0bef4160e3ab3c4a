"""Structure-from-motion layer of the port: relative orientation,
triangulation, absolute orientation, bundle adjustment and dense
stereo."""

from icepy4d_tpu_torch.sfm.absolute_orientation import (  # noqa: F401
    AbsoluteOrientation,
    Absolute_orientation,
    SpaceResection,
    Space_resection,
    pose_from_known_center,
)
from icepy4d_tpu_torch.sfm.bundle import (  # noqa: F401
    BAConfig,
    BAOutput,
    BundleAdjustment,
)
from icepy4d_tpu_torch.sfm.dense import PlaneSweepStereo  # noqa: F401
from icepy4d_tpu_torch.sfm.geometry import (  # noqa: F401
    estimate_pose,
    fundamental_from_cameras,
    project_points,
    undistort_points,
)
from icepy4d_tpu_torch.sfm.triangulation import Triangulate  # noqa: F401
from icepy4d_tpu_torch.sfm.two_view_geometry import (  # noqa: F401
    RelativeOrientation,
)
