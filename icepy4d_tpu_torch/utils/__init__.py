"""Host utilities of the port (counterpart of `icepy4d_tpu/utils/`):
logging, timing, config, geospatial predicates, DSM and orthophoto,
binned statistics, target tracking, feature time series, site
roto-translations, homography warping."""

from icepy4d_tpu_torch.utils.config import DotDict, parse_cfg  # noqa: F401
from icepy4d_tpu_torch.utils.logger import get_logger, setup_logger  # noqa: F401
from icepy4d_tpu_torch.utils.timer import AverageTimer, timeit  # noqa: F401
from icepy4d_tpu_torch.utils.geospatial import (  # noqa: F401
    ccw_sort_points,
    convex_hull_volume,
    point_in_hull,
    point_in_rect,
    point_in_volume,
    points_in_rect,
    select_features_by_rect,
)
from icepy4d_tpu_torch.utils.dsm_orthophoto import (  # noqa: F401
    DSM,
    build_dsm,
    dem_of_difference,
    generate_orthophoto,
    save_dsm_npz,
)
from icepy4d_tpu_torch.utils.binned_stats import binned_statistic  # noqa: F401
from icepy4d_tpu_torch.utils.rototranslation import (  # noqa: F401
    Rototranslation,
    Rotrotranslation,
    belvedere_loc2utm,
    belvedere_utm2loc,
)
from icepy4d_tpu_torch.utils.tracking_features_utils import (  # noqa: F401
    compute_displacements,
    sort_features_by_cam,
    tracked_features_time_series,
    tracked_points_time_series,
    tracked_time_series_to_df,
)
from icepy4d_tpu_torch.utils.track_targets import TrackTargets  # noqa: F401
