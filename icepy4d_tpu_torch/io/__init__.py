"""Point-cloud files of the port."""

from icepy4d_tpu_torch.io.ply import read_ply, write_ply  # noqa: F401
