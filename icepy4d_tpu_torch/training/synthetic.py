"""Synthetic-geometry data for self-training SuperPoint (counterpart of
`icepy4d_tpu/training/synthetic.py`).

The published SuperPoint pipeline bootstraps its detector on rendered
shapes with exactly known corners ("MagicPoint", DeTone et al. 2018
§5.1): random polygons, line junctions, stars, checkerboards and
ellipses (negatives), plus photometric noise. Real-image pairs are
homographic warps of patches cut from real frames.

Host-side numpy and cv2 only; cv2 is imported by the functions that
draw or warp. Every draw is taken from the caller's
`np.random.default_rng` in the order the JAX package takes it, so one
seed gives both packages the same arrays bit for bit.
"""

from __future__ import annotations

import numpy as np


def _cv2():
    import cv2

    return cv2


def _canvas(rng, h, w):
    return np.full((h, w), rng.uniform(0.1, 0.9), np.float32)


def _rand_color(rng, bg):
    # contrast-guaranteed foreground
    c = rng.uniform(0.0, 1.0)
    while abs(c - bg) < 0.25:
        c = rng.uniform(0.0, 1.0)
    return float(c)


def draw_polygon(rng, img):
    h, w = img.shape
    n = int(rng.integers(3, 7))
    cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
    radius = rng.uniform(0.1, 0.3) * min(h, w)
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    pts = np.stack([cx + radius * np.cos(angles),
                    cy + radius * np.sin(angles)], -1)
    _cv2().fillPoly(img, [pts.astype(np.int32)],
                    _rand_color(rng, float(img[0, 0])))
    return pts


def draw_lines(rng, img):
    """Random segments; corners = endpoints + pairwise intersections."""
    cv2 = _cv2()
    h, w = img.shape
    n = int(rng.integers(2, 5))
    segs = []
    for _ in range(n):
        p = rng.uniform([0, 0], [w, h], (2, 2)).astype(np.float32)
        cv2.line(img, tuple(p[0].astype(int)), tuple(p[1].astype(int)),
                 _rand_color(rng, float(img[0, 0])),
                 int(rng.integers(1, 3)))
        segs.append(p)
    corners = [p for s in segs for p in s]
    for i in range(len(segs)):
        for j in range(i + 1, len(segs)):
            pt = _seg_intersect(segs[i], segs[j])
            if pt is not None:
                corners.append(pt)
    return np.asarray(corners, np.float32).reshape(-1, 2)


def _seg_intersect(a, b):
    p, r = a[0], a[1] - a[0]
    q, s = b[0], b[1] - b[0]
    denom = r[0] * s[1] - r[1] * s[0]
    if abs(denom) < 1e-9:
        return None
    t = ((q - p)[0] * s[1] - (q - p)[1] * s[0]) / denom
    u = ((q - p)[0] * r[1] - (q - p)[1] * r[0]) / denom
    if 0.05 < t < 0.95 and 0.05 < u < 0.95:
        return p + t * r
    return None


def draw_star(rng, img):
    cv2 = _cv2()
    h, w = img.shape
    cx, cy = rng.uniform(0.25, 0.75) * w, rng.uniform(0.25, 0.75) * h
    n = int(rng.integers(3, 6))
    col = _rand_color(rng, float(img[0, 0]))
    pts = [np.array([cx, cy], np.float32)]
    for _ in range(n):
        ang = rng.uniform(0, 2 * np.pi)
        radius = rng.uniform(0.08, 0.25) * min(h, w)
        p = np.array([cx + radius * np.cos(ang),
                      cy + radius * np.sin(ang)], np.float32)
        cv2.line(img, (int(cx), int(cy)), tuple(p.astype(int)), col,
                 int(rng.integers(1, 3)))
        pts.append(p)
    return np.asarray(pts, np.float32)


def draw_checkerboard(rng, img):
    h, w = img.shape
    rows, cols = int(rng.integers(2, 5)), int(rng.integers(2, 5))
    cell = int(rng.uniform(0.06, 0.15) * min(h, w))
    x0 = int(rng.uniform(0.05, 0.5) * w)
    y0 = int(rng.uniform(0.05, 0.5) * h)
    c1 = _rand_color(rng, float(img[0, 0]))
    c2 = _rand_color(rng, c1)
    corners = []
    for i in range(rows):
        for j in range(cols):
            y, x = y0 + i * cell, x0 + j * cell
            if y + cell >= h or x + cell >= w:
                continue
            img[y:y + cell, x:x + cell] = c1 if (i + j) % 2 else c2
    for i in range(rows + 1):
        for j in range(cols + 1):
            y, x = y0 + i * cell, x0 + j * cell
            if 0 <= y < h and 0 <= x < w and y + 1 < h and x + 1 < w:
                corners.append([x, y])
    return np.asarray(corners, np.float32).reshape(-1, 2)


def draw_ellipse(rng, img):
    """Negative sample: smooth contour, no corners."""
    h, w = img.shape
    _cv2().ellipse(
        img,
        (int(rng.uniform(0.3, 0.7) * w), int(rng.uniform(0.3, 0.7) * h)),
        (int(rng.uniform(0.05, 0.2) * w), int(rng.uniform(0.05, 0.2) * h)),
        float(rng.uniform(0, 180)), 0, 360,
        _rand_color(rng, float(img[0, 0])), -1)
    return np.zeros((0, 2), np.float32)


SHAPES = (draw_polygon, draw_lines, draw_star, draw_checkerboard,
          draw_ellipse)


def synthetic_sample(rng, h: int = 120, w: int = 160):
    """One image + ground-truth corner list (possibly empty)."""
    img = _canvas(rng, h, w)
    corners = SHAPES[int(rng.integers(len(SHAPES)))](rng, img)
    # photometric nuisance
    if rng.uniform() < 0.8:
        img = _cv2().GaussianBlur(img, (0, 0), rng.uniform(0.4, 1.2))
    img = img + rng.normal(0, rng.uniform(0.01, 0.05), img.shape)
    img = np.clip(img, 0, 1).astype(np.float32)
    # drop out-of-bounds corners
    if len(corners):
        keep = ((corners[:, 0] >= 2) & (corners[:, 0] < w - 2)
                & (corners[:, 1] >= 2) & (corners[:, 1] < h - 2))
        corners = corners[keep]
    return img, corners


def corners_to_cells(corners, h: int, w: int) -> np.ndarray:
    """Corner list -> 65-way cell labels (8x8 cells + dustbin = 64).

    One corner per cell at most: the label is the corner's sub-cell
    index, empty cells get the dustbin.
    """
    hc, wc = h // 8, w // 8
    labels = np.full((hc, wc), 64, np.int32)
    for x, y in corners:
        ci, cj = int(y) // 8, int(x) // 8
        if 0 <= ci < hc and 0 <= cj < wc:
            labels[ci, cj] = (int(y) % 8) * 8 + (int(x) % 8)
    return labels


def make_batch(rng, batch: int, h: int = 120, w: int = 160):
    """(images (B, H, W), labels (B, H/8, W/8) int32) training batch."""
    imgs = np.empty((batch, h, w), np.float32)
    labels = np.empty((batch, h // 8, w // 8), np.int32)
    for i in range(batch):
        img, corners = synthetic_sample(rng, h, w)
        imgs[i] = img
        labels[i] = corners_to_cells(corners, h, w)
    return imgs, labels


def random_homography(rng, h: int, w: int, strength: float = 0.15):
    """Random perspective warp: the image corners jittered by up to
    `strength` of the image size."""
    src = np.array([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    jitter = rng.uniform(-strength, strength, (4, 2)).astype(np.float32)
    dst = (src + jitter * np.asarray([w, h], np.float32)).astype(
        np.float32)
    return _cv2().getPerspectiveTransform(
        np.ascontiguousarray(src.reshape(4, 1, 2)),
        np.ascontiguousarray(dst.reshape(4, 1, 2))).astype(np.float32)


def _warp(img, H, w, h):
    cv2 = _cv2()
    return cv2.warpPerspective(img, H, (w, h), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_REFLECT)


def make_pair_batch(rng, batch: int, h: int = 120, w: int = 160):
    """Homography-related image pairs + per-pair H (descriptor stage):
    (imgs, warped, Hs (B, 3, 3), labels)."""
    imgs, labels = make_batch(rng, batch, h, w)
    warped = np.empty_like(imgs)
    Hs = np.empty((batch, 3, 3), np.float32)
    for i in range(batch):
        H = random_homography(rng, h, w)
        warped[i] = _warp(imgs[i], H, w, h)
        Hs[i] = H
    return imgs, warped, Hs, labels


def load_real_patch_pool(image_dir, max_images: int = 16,
                         gray: bool = True):
    """Decode up to `max_images` frames under `image_dir` (jpg, jpeg,
    png, sorted by path) as float32 gray in [0, 1]."""
    from pathlib import Path

    cv2 = _cv2()
    pool = []
    for p in sorted(Path(image_dir).rglob("*")):
        if p.suffix.lower() not in (".jpg", ".jpeg", ".png"):
            continue
        img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        if img is None:
            continue
        pool.append(img.astype(np.float32) / 255.0)
        if len(pool) >= max_images:
            break
    if not pool:
        raise FileNotFoundError(f"no images under {image_dir}")
    return pool


def make_real_pair_batch(rng, pool, batch: int, h: int = 120,
                         w: int = 160):
    """Real-image patches + homographic warps: correspondence
    supervision for the descriptor head without labels.

    Returns (imgs, warped, Hs, labels) with all-dustbin labels; the
    caller masks the detector loss of such batches."""
    imgs = np.empty((batch, h, w), np.float32)
    warped = np.empty_like(imgs)
    Hs = np.empty((batch, 3, 3), np.float32)
    for i in range(batch):
        src = pool[int(rng.integers(len(pool)))]
        sh, sw = src.shape
        y0 = int(rng.integers(0, max(sh - h, 1)))
        x0 = int(rng.integers(0, max(sw - w, 1)))
        patch = src[y0:y0 + h, x0:x0 + w]
        if patch.shape != (h, w):
            patch = _cv2().resize(patch, (w, h))
        # photometric jitter so descriptors cannot key on brightness
        patch = np.clip(patch * rng.uniform(0.7, 1.3)
                        + rng.uniform(-0.1, 0.1), 0, 1)
        patch = patch.astype(np.float32)
        H = random_homography(rng, h, w, strength=0.1)
        imgs[i] = patch
        warped[i] = _warp(patch, H, w, h)
        Hs[i] = H
    labels = np.full((batch, h // 8, w // 8), 64, np.int32)
    return imgs, warped, Hs, labels
