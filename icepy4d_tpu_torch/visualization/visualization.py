"""Plotting utilities (counterpart of
`icepy4d_tpu/visualization/visualization.py`).

Host-side matplotlib and cv2 plots of keypoints, matches, epipolar
lines, reprojections, point clouds (matplotlib 3-D; open3d is not
needed) and camera-parameter time series. Figures are returned (and
saved when a path is given) rather than shown, so they work headless.
matplotlib and cv2 are imported when a plot is made, never when the
module is imported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib

    if matplotlib.get_backend().lower() != "agg":
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, path):
    if path is not None:
        plt = _pyplot()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(path, bbox_inches="tight", dpi=150)
        plt.close(fig)
    return fig


def plot_image_pair(image0, image1, dpi=100, size=6, pad=0.5):
    """Side-by-side image axes. Returns (fig, axes)."""
    plt = _pyplot()
    fig, ax = plt.subplots(1, 2, figsize=(size * 2, size), dpi=dpi)
    for a, im in zip(ax, (image0, image1)):
        a.imshow(im, cmap="gray" if np.ndim(im) == 2 else None)
        a.set_axis_off()
    fig.tight_layout(pad=pad)
    return fig, ax


def plot_keypoints(kpts0, kpts1, axes=None, color="w", ps=2):
    """Scatter keypoints onto a pair of axes."""
    assert axes is not None, "pass the axes from plot_image_pair"
    axes[0].scatter(kpts0[:, 0], kpts0[:, 1], c=color, s=ps)
    axes[1].scatter(kpts1[:, 0], kpts1[:, 1], c=color, s=ps)
    return axes


def plot_matches(
    image0, image1, kpts0, kpts1, color=None, path=None,
    point_size=4, lw=0.4, max_lines=500,
):
    """Match line art across an image pair."""
    plt = _pyplot()
    fig, ax = plot_image_pair(image0, image1)
    kpts0 = np.asarray(kpts0)
    kpts1 = np.asarray(kpts1)
    n = len(kpts0)
    if color is None:
        color = plt.cm.jet(np.linspace(0, 1, max(n, 1)))
    elif isinstance(color, str):
        from matplotlib.colors import to_rgba

        color = [to_rgba(color)] * max(n, 1)
    ax[0].scatter(kpts0[:, 0], kpts0[:, 1], c=color, s=point_size)
    ax[1].scatter(kpts1[:, 0], kpts1[:, 1], c=color, s=point_size)
    fig.canvas.draw()
    tf = fig.transFigure.inverted()
    step = max(1, n // max_lines)
    from matplotlib.lines import Line2D

    for i in range(0, n, step):
        p0 = tf.transform(ax[0].transData.transform(kpts0[i]))
        p1 = tf.transform(ax[1].transData.transform(kpts1[i]))
        fig.lines.append(Line2D((p0[0], p1[0]), (p0[1], p1[1]),
                                transform=fig.transFigure,
                                c=color[i % len(color)], lw=lw))
    return _save(fig, path)


def _to_bgr(im) -> np.ndarray:
    """uint8 BGR of a gray or colour image; float images in [0, 1] are
    scaled by 255, others clipped."""
    import cv2

    im = np.asarray(im)
    if im.dtype != np.uint8:
        im = np.clip(im, 0, 255).astype(np.uint8) if im.max() > 1 \
            else (im * 255).astype(np.uint8)
    if im.ndim == 2:
        im = cv2.cvtColor(im, cv2.COLOR_GRAY2BGR)
    return im


def plot_matches_cv2(image0, image1, pts0, pts1, path=None, point_size=3,
                     line_thickness=1, max_lines=1000) -> np.ndarray:
    """Side-by-side mosaic of two images with every k-th match drawn (at
    most about `max_lines`), each in a colour seeded by its index;
    written to `path` when given. Returns the BGR mosaic."""
    import cv2

    im0, im1 = _to_bgr(image0), _to_bgr(image1)
    h = max(im0.shape[0], im1.shape[0])
    mosaic = np.zeros((h, im0.shape[1] + im1.shape[1], 3), np.uint8)
    mosaic[:im0.shape[0], :im0.shape[1]] = im0
    mosaic[:im1.shape[0], im0.shape[1]:] = im1
    off = im0.shape[1]
    pts0 = np.asarray(pts0).astype(int)
    pts1 = np.asarray(pts1).astype(int)
    for i in range(0, len(pts0), max(1, len(pts0) // max_lines)):
        c = tuple(int(v) for v in np.random.default_rng(i).integers(
            64, 255, 3))
        p0 = tuple(int(v) for v in pts0[i])
        p1 = (int(pts1[i][0]) + off, int(pts1[i][1]))
        cv2.circle(mosaic, p0, point_size, c, -1)
        cv2.circle(mosaic, p1, point_size, c, -1)
        cv2.line(mosaic, p0, p1, c, line_thickness)
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(path), mosaic)
    return mosaic


def plot_points(image, points, title=None, path=None, ps=6, c="r"):
    """Scatter 2D points on an image."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    ax.imshow(image, cmap="gray" if np.ndim(image) == 2 else None)
    points = np.asarray(points)
    ax.scatter(points[:, 0], points[:, 1], s=ps, c=c, marker="x")
    if title:
        ax.set_title(title)
    ax.set_axis_off()
    return _save(fig, path)


def plot_features(image, features, title=None, path=None, **kw):
    """Plot a Features object's keypoints."""
    return plot_points(image, features.kpts_to_numpy(), title=title,
                       path=path, **kw)


def plot_projections(points3d, camera, image, title=None, path=None,
                     **kw):
    """Project world points into a camera and plot."""
    proj = np.asarray(camera.project_point(
        np.asarray(points3d, np.float32)))
    return plot_points(image, proj, title=title, path=path, **kw)


def plot_projection_error(
    projections, observations, image=None, path=None, cmap="viridis",
    point_size=6,
):
    """Scatter colored by reprojection residual norm."""
    plt = _pyplot()
    projections = np.asarray(projections)
    observations = np.asarray(observations)
    err = np.linalg.norm(projections - observations, axis=1)
    fig, ax = plt.subplots()
    if image is not None:
        ax.imshow(image, cmap="gray" if np.ndim(image) == 2 else None)
    sc = ax.scatter(observations[:, 0], observations[:, 1], c=err,
                    cmap=cmap, s=point_size)
    fig.colorbar(sc, ax=ax, label="reprojection error [px]")
    return _save(fig, path)


def draw_epip_lines(img0, img1, lines, pts0, pts1, fast_viz=True):
    """Draw epipolar lines `lines` (a,b,c rows) on img0 with the matched
    points. Returns annotated (img0, img1)."""
    import cv2

    r, c = img0.shape[:2]
    im0 = img0.copy() if img0.ndim == 3 else cv2.cvtColor(
        img0, cv2.COLOR_GRAY2BGR)
    im1 = img1.copy() if img1.ndim == 3 else cv2.cvtColor(
        img1, cv2.COLOR_GRAY2BGR)
    rng = np.random.default_rng(0)
    for ln, p0, p1 in zip(lines, np.asarray(pts0, int),
                          np.asarray(pts1, int)):
        color = tuple(int(v) for v in rng.integers(0, 255, 3))
        x0, y0 = 0, int(-ln[2] / ln[1]) if ln[1] != 0 else 0
        x1, y1 = c, int(-(ln[2] + ln[0] * c) / ln[1]) if ln[1] != 0 else r
        im0 = cv2.line(im0, (x0, y0), (x1, y1), color, 1)
        im0 = cv2.circle(im0, tuple(p0), 5, color, -1)
        im1 = cv2.circle(im1, tuple(p1), 5, color, -1)
    return im0, im1


def make_camera_pyramid(camera, scale=1.0):
    """Camera frustum as line segments (world frame) for 3-D plotting."""
    K = np.asarray(camera.K)
    w = camera.width or int(K[0, 2] * 2)
    h = camera.height or int(K[1, 2] * 2)
    corners_cam = np.array([
        [0, 0, 0],
        [(0 - K[0, 2]) / K[0, 0], (0 - K[1, 2]) / K[1, 1], 1.0],
        [(w - K[0, 2]) / K[0, 0], (0 - K[1, 2]) / K[1, 1], 1.0],
        [(w - K[0, 2]) / K[0, 0], (h - K[1, 2]) / K[1, 1], 1.0],
        [(0 - K[0, 2]) / K[0, 0], (h - K[1, 2]) / K[1, 1], 1.0],
    ]) * scale
    E = np.asarray(camera.extrinsics)
    Rcw = E[:3, :3].T
    C = -Rcw @ E[:3, 3]
    world = corners_cam @ Rcw.T + C
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4),
             (4, 1)]
    return [(world[a], world[b]) for a, b in edges]


def display_point_cloud(
    points, colors=None, cameras=None, path=None, ps=1, view=None,
):
    """3-D scatter of a point cloud (+camera frusta) with matplotlib."""
    plt = _pyplot()
    points = np.asarray(points)
    if colors is not None:
        colors = np.asarray(colors)
        if np.issubdtype(colors.dtype, np.integer):
            colors = colors / 255.0   # read_ply returns uint8 RGB
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=ps,
               c=colors if colors is not None else "steelblue")
    if cameras:
        for cam in cameras:
            for a, b in make_camera_pyramid(cam, scale=2.0):
                ax.plot(*zip(a, b), c="r", lw=1)
    if view:
        ax.view_init(*view)
    return _save(fig, path)


def plot_camera_time_series(csv_path, camera_names=None, path=None):
    """Focal-length + angle time series from estimated_cameras.csv."""
    plt = _pyplot()
    import pandas as pd

    df = pd.read_csv(csv_path)
    if camera_names is None:
        # strip the metric suffix only: camera names may contain '_'
        camera_names = sorted({c[: -len("_f")] for c in df.columns
                               if c.endswith("_f")})
    fig, axes = plt.subplots(2, 1, figsize=(10, 7), sharex=True)
    for cam in camera_names:
        axes[0].plot(df["epoch"], df[f"{cam}_f"], marker="o", label=cam)
        for ang in ("omega", "phi", "kappa"):
            axes[1].plot(df["epoch"], df[f"{cam}_{ang}"], marker=".",
                         label=f"{cam} {ang}")
    axes[0].set_ylabel("focal [px]")
    axes[1].set_ylabel("angle [deg]")
    for a in axes:
        a.legend(fontsize=7)
        a.grid(alpha=0.3)
    fig.autofmt_xdate()
    return _save(fig, path)


def imshow_cv2(img, win_name="image", convert_RGB2BGR=True,
               resize_to=None):
    """Display an image in a cv2 window. Headless-safe:
    returns the (possibly resized/converted) array and only opens a
    window when a display is available."""
    import os

    import cv2

    out = np.asarray(img)
    if resize_to is not None:
        scale = resize_to / max(out.shape[:2])
        out = cv2.resize(out, None, fx=scale, fy=scale)
    if convert_RGB2BGR and out.ndim == 3:
        out = cv2.cvtColor(out, cv2.COLOR_RGB2BGR)
    if os.environ.get("DISPLAY"):
        cv2.imshow(win_name, out)
        cv2.waitKey(1)
    return out


def get_colors(inp, colormap="viridis", vmin=None, vmax=None):
    """Map scalars to RGBA via a matplotlib colormap."""
    plt = _pyplot()
    inp = np.asarray(inp, float)
    vmin = np.min(inp) if vmin is None else vmin
    vmax = np.max(inp) if vmax is None else vmax
    norm = plt.Normalize(vmin, vmax)
    return plt.get_cmap(colormap)(norm(inp))


def draw_matches(axes, kpts0, kpts1, color=None, lw=1.5, ps=4):
    """Line art between already-plotted image axes.
    `color` may be one color spec (applied to all matches) or a
    per-match sequence."""
    plt = _pyplot()
    from matplotlib.colors import to_rgba

    fig = axes[0].figure
    kpts0 = np.asarray(kpts0)
    kpts1 = np.asarray(kpts1)
    n = len(kpts0)
    if color is None:
        color = plt.cm.jet(np.linspace(0, 1, max(n, 1)))
    elif isinstance(color, str) or (
            np.ndim(color) == 1 and len(color) in (3, 4)
            and not isinstance(color[0], (str, tuple, list, np.ndarray))):
        color = [to_rgba(color)] * max(n, 1)
    fig.canvas.draw()
    tf = fig.transFigure.inverted()
    from matplotlib.lines import Line2D

    for i in range(n):
        p0 = tf.transform(axes[0].transData.transform(kpts0[i]))
        p1 = tf.transform(axes[1].transData.transform(kpts1[i]))
        fig.lines.append(Line2D((p0[0], p1[0]), (p0[1], p1[1]),
                                transform=fig.transFigure,
                                c=color[i % len(color)], lw=lw))
    axes[0].scatter(kpts0[:, 0], kpts0[:, 1], c=color, s=ps)
    axes[1].scatter(kpts1[:, 0], kpts1[:, 1], c=color, s=ps)
    return axes


def plot_matches_epoch(epoch, out_dir, cams=None, show_fig=False):
    """Epoch-level match plot: draw the two cameras'
    matched features and save <epoch.date_str>_matches.png."""
    cams = cams or sorted(epoch.images.keys())[:2]
    f0 = epoch.features[cams[0]]
    f1 = epoch.features[cams[1]]
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{epoch.date_str}_matches.png"
    plot_matches_cv2(epoch.images[cams[0]].value,
                     epoch.images[cams[1]].value,
                     f0.kpts_to_numpy(), f1.kpts_to_numpy(),
                     path=path)
    return path


def plot_points_cv2(image, points, path=None, radius=4,
                    color=(0, 0, 255), with_ids=False):
    """Fast cv2 point rendering. Returns BGR image."""
    import cv2

    im = np.asarray(image)
    if im.dtype != np.uint8:
        im = np.clip(im * 255 if im.max() <= 1 else im,
                     0, 255).astype(np.uint8)
    if im.ndim == 2:
        im = cv2.cvtColor(im, cv2.COLOR_GRAY2BGR)
    else:
        im = im.copy()
    for i, (x, y) in enumerate(np.asarray(points, int)):
        cv2.circle(im, (int(x), int(y)), radius, color, -1)
        if with_ids:
            cv2.putText(im, str(i), (int(x) + 3, int(y) - 3),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(path), im)
    return im


def plot_feature(image, feature_xy, title=None, path=None, zoom=None,
                 ps=50, c="r"):
    """Single-feature plot, optionally zoomed around it."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    ax.imshow(image, cmap="gray" if np.ndim(image) == 2 else None)
    x, y = float(feature_xy[0]), float(feature_xy[1])
    ax.scatter(x, y, s=ps, c=c, marker="+")
    if zoom is not None:
        ax.set_xlim(x - zoom, x + zoom)
        ax.set_ylim(y + zoom, y - zoom)
    if title:
        ax.set_title(title)
    ax.set_axis_off()
    return _save(fig, path)


def pose2pyramid(camera_pose, focal_len_scaled=5, aspect_ratio=0.3):
    """Camera-pose 4x4 -> frustum vertex array."""
    T = np.asarray(camera_pose)
    w = focal_len_scaled * aspect_ratio
    verts_cam = np.array([
        [0, 0, 0, 1],
        [w, -w, focal_len_scaled, 1],
        [w, w, focal_len_scaled, 1],
        [-w, w, focal_len_scaled, 1],
        [-w, -w, focal_len_scaled, 1],
    ])
    return (verts_cam @ T.T)[:, :3]


def display_pc_inliers(points, ind, path=None, ps=1):
    """Inlier/outlier split view of a cloud: inliers
    gray, outliers red."""
    plt = _pyplot()
    points = np.asarray(points)
    mask = np.zeros(len(points), bool)
    mask[np.asarray(ind, int)] = True
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(*points[mask].T, s=ps, c="0.6", label="inliers")
    if (~mask).any():
        ax.scatter(*points[~mask].T, s=ps * 3, c="r", label="outliers")
    ax.legend()
    return _save(fig, path)


def make_focal_length_variation_plot(focals, epoch_labels=None,
                                     path=None):
    """Per-epoch focal length series. `focals` is a
    (T,) array or {cam: (T,) array} dict."""
    plt = _pyplot()
    if not isinstance(focals, dict):
        focals = {"camera": np.asarray(focals)}
    fig, ax = plt.subplots(figsize=(10, 4))
    for cam, f in focals.items():
        ax.plot(np.arange(len(f)) if epoch_labels is None
                else epoch_labels, f, marker="o", label=cam)
    ax.set_xlabel("epoch")
    ax.set_ylabel("focal length [px]")
    ax.grid(alpha=0.3)
    ax.legend()
    return _save(fig, path)


def make_camera_angles_plot(angles, path=None):
    """Per-epoch camera angle series. `angles` is
    {cam: {"omega"|"phi"|"kappa": (T,)}}."""
    plt = _pyplot()
    fig, axes = plt.subplots(3, 1, figsize=(10, 8), sharex=True)
    for cam, d in angles.items():
        for ax, name in zip(axes, ("omega", "phi", "kappa")):
            if name in d:
                ax.plot(np.asarray(d[name]), marker=".",
                        label=f"{cam}")
                ax.set_ylabel(f"{name} [deg]")
                ax.grid(alpha=0.3)
    axes[0].legend(fontsize=8)
    axes[-1].set_xlabel("epoch")
    return _save(fig, path)
