"""Camera model and calibration files of the port."""

from icepy4d_tpu_torch.core.calibration import (  # noqa: F401
    Calibration,
    read_opencv_calibration,
    read_xml_calibration,
)
from icepy4d_tpu_torch.core.camera import Camera  # noqa: F401
