"""Plots of the port (counterpart of part of `icepy4d_tpu/visualization`):
so far the cv2 match mosaic the matcher writes under `other.do_viz`."""

from icepy4d_tpu_torch.visualization.visualization import (  # noqa: F401
    plot_matches_cv2,
)
