"""Image ops: grayscale, pyramids, resize, tiling, bilinear sampling,
homography warps and undistortion.

Counterpart of `icepy4d_tpu/ops/image.py`. Pixel grids are mapped by
3x3 matrices elementwise (`map_homography`), never by a matmul, so that
no TF32 setting can move a coordinate near 6000 px by whole pixels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from icepy4d_tpu_torch.ops.geometry import distort_normalized

# ITU-R BT.601 luma weights, as cv2.cvtColor(..., COLOR_RGB2GRAY)
_LUMA = (0.299, 0.587, 0.114)

# cv2.pyrDown/pyrUp 5-tap Gaussian kernel (1,4,6,4,1)/16
_GAUSS5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) -> (..., H, W) luma. uint8 input is scaled to [0,1]."""
    img = image.to(torch.float32)
    if image.dtype == torch.uint8:
        img = img / 255.0
    return img @ torch.tensor(_LUMA, dtype=torch.float32, device=img.device)


def _sep_conv5(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable 5-tap filter with reflect padding on (H, W) or (H, W, C)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    x = img.permute(2, 0, 1)[:, None]                     # (C, 1, H, W)
    k = torch.as_tensor(kernel, dtype=torch.float32, device=img.device)
    x = F.pad(x, (2, 2, 2, 2), mode="reflect")
    x = F.conv2d(x, k.reshape(1, 1, 5, 1))
    x = F.conv2d(x, k.reshape(1, 1, 1, 5))
    out = x[:, 0].permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def pyr_down(image: torch.Tensor) -> torch.Tensor:
    """Gaussian blur + 2x decimation (cv2.pyrDown semantics)."""
    return _sep_conv5(image.to(torch.float32), _GAUSS5)[::2, ::2]


def pyr_up(image: torch.Tensor) -> torch.Tensor:
    """2x zero-stuffed upsample + 4*Gaussian smoothing (cv2.pyrUp semantics)."""
    img = image.to(torch.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    up = img.new_zeros((2 * h, 2 * w, c))
    up[::2, ::2] = img
    out = _sep_conv5(up, _GAUSS5 * 2.0)
    return out[..., 0] if squeeze else out


def quality_resize(image: torch.Tensor, quality: str) -> torch.Tensor:
    """Quality ladder: highest=pyrUp x1, high=identity, medium=pyrDown x1,
    low=pyrDown x2."""
    q = quality.lower()
    if q == "highest":
        return pyr_up(image)
    if q == "high":
        return image.to(torch.float32)
    if q == "medium":
        return pyr_down(image)
    if q == "low":
        return pyr_down(pyr_down(image))
    raise ValueError(f"unknown quality {quality!r}")


def compute_tile_limits(
    h: int, w: int, grid: tuple[int, int], overlap: int = 0,
) -> np.ndarray:
    """Tile origins and one uniform size for a (rows, cols) grid.

    Steps are rounded down to a multiple of 10 px; the last row and
    column are pinned to the image edge so no strip goes uncovered.
    Returns int array (rows*cols, 4) of [x0, y0, tw, th].
    """
    rows, cols = grid
    dx = (w // cols) // 10 * 10
    dy = (h // rows) // 10 * 10
    tw = min(dx + 2 * overlap, w)
    th = min(dy + 2 * overlap, h)
    lims = []
    for r in range(rows):
        for c in range(cols):
            x0 = w - tw if c == cols - 1 else \
                min(max(c * dx - overlap, 0), w - tw)
            y0 = h - th if r == rows - 1 else \
                min(max(r * dy - overlap, 0), h - th)
            lims.append([x0, y0, tw, th])
    return np.asarray(lims, np.int32)


def extract_tiles(image: torch.Tensor, origins, tile_h: int,
                  tile_w: int) -> torch.Tensor:
    """(H, W[, C]) image, (T, 2) int [x0, y0] origins -> (T, th, tw[, C])."""
    return torch.stack([image[int(y):int(y) + tile_h, int(x):int(x) + tile_w]
                        for x, y in np.asarray(origins)])


def bilinear_sample(image: torch.Tensor, xy: torch.Tensor,
                    pad_value: float = 0.0) -> torch.Tensor:
    """Sample (H, W[, C]) at float pixel coords xy (N, 2) -> (N[, C]).

    Out-of-bounds taps read pad_value (cv2 BORDER_CONSTANT).
    """
    return bilinear_sample_batched(image[None], xy[None], pad_value)[0]


def bilinear_sample_batched(images: torch.Tensor, xy: torch.Tensor,
                            pad_value: float = 0.0) -> torch.Tensor:
    """`bilinear_sample` of each image of (B, H, W[, C]) at its own
    coords xy (B, ..., 2) -> (B, ...[, C]).

    One gather over the flattened batch, so a backward accumulates into
    one buffer instead of one a sample call."""
    squeeze = images.ndim == 3
    img = (images[..., None] if squeeze else images).to(torch.float32)
    b, h, w, c = img.shape
    flat = img.reshape(b * h * w, c)
    base = (torch.arange(b, device=xy.device) * (h * w)).reshape(
        (b,) + (1,) * (xy.ndim - 2))
    x, y = xy[..., 0], xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(xi, yi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, pad_value)

    out = (tap(x0i, y0i) * (1 - fx) * (1 - fy)
           + tap(x0i + 1, y0i) * fx * (1 - fy)
           + tap(x0i, y0i + 1) * (1 - fx) * fy
           + tap(x0i + 1, y0i + 1) * fx * fy)
    return out[..., 0] if squeeze else out


def resize(image: torch.Tensor, shape: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (H, W[, C]) to `shape` = (h, w).

    Antialiased when it shrinks, as `jax.image.resize(..., "bilinear")`
    is (half-pixel centres, a triangle kernel widened by the scale).
    """
    img = image.to(torch.float32)
    squeeze = img.ndim == 2
    x = img[None, None] if squeeze else img.permute(2, 0, 1)[None]
    out = F.interpolate(x, size=tuple(shape), mode="bilinear",
                        align_corners=False, antialias=True)[0]
    return out[0] if squeeze else out.permute(1, 2, 0)


def _pixel_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(xs, ys): the (h, w) float32 column and row index of every pixel."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return xs, ys


def map_homography(M, xs: torch.Tensor, ys: torch.Tensor):
    """M @ [x, y, 1] for every pixel, elementwise: (qx, qy, qz).

    M is a 3x3 host array; its entries enter as float32 scalars.
    """
    M = np.asarray(M, np.float32)
    return tuple(xs * float(M[i, 0]) + ys * float(M[i, 1]) + float(M[i, 2])
                 for i in range(3))


def warp_homography(image: torch.Tensor, H, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Inverse-map homography warp (cv2.warpPerspective semantics):
    out(x) = image(H^-1 x), zero outside. H: 3x3 host array."""
    Hinv = np.linalg.inv(np.asarray(H, np.float32))
    xs, ys = _pixel_grid(out_h, out_w, image.device)
    sx, sy, sz = map_homography(Hinv, xs, ys)
    den = torch.clamp_min(sz.abs(), 1e-12)
    sign = torch.sign(sz)
    src = torch.stack([sx / den * sign, sy / den * sign], -1)
    out = bilinear_sample(image, src.reshape(-1, 2))
    return out.reshape((out_h, out_w) + tuple(image.shape[2:]))


def undistort_image(image: torch.Tensor, K, dist) -> torch.Tensor:
    """Remove lens distortion (cv2.undistort semantics, same K on output).

    For each output pixel: normalise with K^-1, apply the FORWARD
    distortion, re-project with K, sample the distorted source there.
    K: 3x3 host array; dist: OpenCV coefficients (up to 8).
    """
    h, w = image.shape[:2]
    K = np.asarray(K, np.float32)
    xs, ys = _pixel_grid(h, w, image.device)
    xn, yn, _ = map_homography(np.linalg.inv(K), xs, ys)
    xd = distort_normalized(torch.stack([xn, yn], -1), dist)
    u = xd[..., 0] * float(K[0, 0]) + xd[..., 1] * float(K[0, 1]) \
        + float(K[0, 2])
    v = xd[..., 0] * float(K[1, 0]) + xd[..., 1] * float(K[1, 1]) \
        + float(K[1, 2])
    out = bilinear_sample(image, torch.stack([u, v], -1).reshape(-1, 2))
    return out.reshape(image.shape)


def make_homography(K0, R0, K1, R1) -> np.ndarray:
    """Rotation-only homography mapping cam1 pixels into cam0's frame:
    H = K0 R0 R1^T K1^-1 (float32, host)."""
    K0, R0, K1, R1 = (np.asarray(a, np.float32) for a in (K0, R0, K1, R1))
    return K0 @ (R0 @ R1.T) @ np.linalg.inv(K1)
