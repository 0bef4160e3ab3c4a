"""Files of the port: point clouds and the CSV metric sinks."""

from icepy4d_tpu_torch.io.export2textfile import (  # noqa: F401
    export_keypoints,
    export_points3D,
    write_cameras_to_file,
    write_reprojection_error_to_file,
)
from icepy4d_tpu_torch.io.ply import read_ply, write_ply  # noqa: F401
