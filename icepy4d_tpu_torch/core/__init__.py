"""Core data of the port: cameras and calibration files, images and the
sensor width database, features and points (host stores and their
padded device structs), point clouds, targets and epochs."""

from icepy4d_tpu_torch.core.calibration import (  # noqa: F401
    Calibration,
    read_opencv_calibration,
    read_xml_calibration,
)
from icepy4d_tpu_torch.core.camera import Camera  # noqa: F401
from icepy4d_tpu_torch.core.constants import (  # noqa: F401
    DATE_FMT,
    DATETIME_FMT,
    TIME_FMT,
)
from icepy4d_tpu_torch.core.epoch import (  # noqa: F401
    Epoch,
    EpochDataMap,
    Epoches,
)
from icepy4d_tpu_torch.core.features import Features, FeatureSet  # noqa: F401
from icepy4d_tpu_torch.core.images import Image, ImageDS, read_image  # noqa: F401
from icepy4d_tpu_torch.core.point_cloud import PointCloud  # noqa: F401
from icepy4d_tpu_torch.core.points import Points, PointSet  # noqa: F401
from icepy4d_tpu_torch.core.sensor_width_database import (  # noqa: F401
    SensorWidthDatabase,
)
from icepy4d_tpu_torch.core.targets import Targets  # noqa: F401
