"""Native host code of the port: the threaded batch EXIF scanner."""

from icepy4d_tpu_torch.native.exif import (  # noqa: F401
    exif_scan_batch,
    native_available,
)
