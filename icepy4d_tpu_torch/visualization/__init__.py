"""Plots of the port (counterpart of `icepy4d_tpu/visualization/`):
matplotlib and cv2 plots of keypoints, matches, epipolar geometry,
reprojections, point clouds and camera-parameter time series."""

from icepy4d_tpu_torch.visualization.visualization import (  # noqa: F401
    display_pc_inliers,
    display_point_cloud,
    draw_epip_lines,
    draw_matches,
    get_colors,
    imshow_cv2,
    make_camera_angles_plot,
    make_camera_pyramid,
    make_focal_length_variation_plot,
    plot_camera_time_series,
    plot_feature,
    plot_features,
    plot_image_pair,
    plot_keypoints,
    plot_matches,
    plot_matches_cv2,
    plot_matches_epoch,
    plot_points,
    plot_points_cv2,
    plot_projection_error,
    plot_projections,
    pose2pyramid,
)
