"""Files of the port (counterpart of `icepy4d_tpu/io/`): PLY, Bundler,
COLMAP, CALGE and the CSV metric sinks."""

from icepy4d_tpu_torch.io.ply import read_ply, write_ply  # noqa: F401
from icepy4d_tpu_torch.io.export2bundler import (  # noqa: F401
    read_bundler_out,
    write_bundler_out,
    write_odm_gcps,
)
from icepy4d_tpu_torch.io.export2colmap import (  # noqa: F401
    export_solution_to_colmap,
    export_solution_to_colmap_binary,
    export_to_colmap_database,
    features_to_h5,
)
from icepy4d_tpu_torch.io.colmap import (  # noqa: F401
    COLMAPDatabase,
    read_model as read_colmap_model,
    write_model as write_colmap_model,
)
from icepy4d_tpu_torch.io.export2calge import (  # noqa: F401
    export_keypoints_for_calge,
    export_points3D_for_calge,
)
from icepy4d_tpu_torch.io.export2textfile import (  # noqa: F401
    export_keypoints,
    export_points3D,
    write_cameras_to_file,
    write_reprojection_error_to_file,
)
