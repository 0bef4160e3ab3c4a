"""Inputs shared by the port's parity tests (tests/test_torch_*.py).

Everything is made with numpy from a seed, so the JAX package and the
PyTorch port receive the same arrays and parameter trees.
"""

import cv2
import numpy as np

DX, DY = 16, 8   # ground-truth shift of the synthetic pair (8-px aligned)

SP_CONVS = (("conv1a", 3, 1, 64), ("conv1b", 3, 64, 64),
            ("conv2a", 3, 64, 64), ("conv2b", 3, 64, 64),
            ("conv3a", 3, 64, 128), ("conv3b", 3, 128, 128),
            ("conv4a", 3, 128, 128), ("conv4b", 3, 128, 128),
            ("convPa", 3, 128, 256), ("convPb", 1, 256, 65),
            ("convDa", 3, 128, 256), ("convDb", 1, 256, 256))


def superpoint_tree(seed: int = 0) -> dict:
    """Random SuperPoint parameters in the JAX layout (HWIO kernels)."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, k, cin, cout in SP_CONVS:
        fan_in = k * k * cin
        params[name] = {
            "kernel": (rng.normal(size=(k, k, cin, cout))
                       * np.sqrt(2.0 / fan_in)).astype(np.float32),
            "bias": (0.01 * rng.normal(size=(cout,))).astype(np.float32),
        }
    return {"params": params}


def lightglue_tree(n_layers: int, d: int, num_heads: int,
                   seed: int = 0) -> dict:
    """Random LightGlue parameters in the JAX layout (dense (in, out))."""
    rng = np.random.default_rng(seed)
    hd = d // num_heads

    def lin(din, dout):
        return {"kernel": (rng.normal(size=(din, dout))
                           / np.sqrt(din)).astype(np.float32),
                "bias": (0.01 * rng.normal(size=(dout,))).astype(np.float32)}

    def ffn():
        return {"dense1": lin(2 * d, 2 * d),
                "norm": {"scale": (1 + 0.1 * rng.normal(size=(2 * d,))
                                   ).astype(np.float32),
                         "bias": (0.1 * rng.normal(size=(2 * d,))
                                  ).astype(np.float32)},
                "dense2": lin(2 * d, d)}

    return {
        "input_proj": lin(d, d),
        "posenc": {"Wr": {"kernel": rng.normal(size=(2, hd // 2)).astype(
            np.float32)}},
        "layers": [{"self_attn": {"Wqkv": lin(d, 3 * d), "out": lin(d, d),
                                  "ffn": ffn()},
                    "cross_attn": {"to_qk": lin(d, d), "to_v": lin(d, d),
                                   "out": lin(d, d), "ffn": ffn()}}
                   for _ in range(n_layers)],
        "assign": [{"matchability": lin(d, 1), "final_proj": lin(d, d)}
                   for _ in range(n_layers)],
        "confidence": [{"token": lin(d, 1)} for _ in range(n_layers - 1)],
    }


def shifted_pair(h: int = 312, w: int = 400, seed: int = 21):
    """Band-limited texture (8 px per noise cell) and its (DX, DY)-shifted
    copy: img0[y, x] == img1[y - DY, x - DX]."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(size=((h + DY) // 8, (w + DX) // 8)).astype(np.float32)
    base = cv2.resize(lo, (w + DX, h + DY), interpolation=cv2.INTER_CUBIC)
    base = np.clip(base * 255, 0, 255).astype(np.uint8)
    return base[:h, :w], base[DY:, DX:]


def epipolar_pair(n=200, n_out=40, seed=3):
    """General (non-planar) two-view scene with n_out gross outliers first.
    Returns (x0, x1, is_inlier)."""
    rng = np.random.default_rng(seed)
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    x0 = pts @ K.T
    x0 = x0[:, :2] / x0[:, 2:]
    x1 = (pts + [1.0, 0.0, 0.0]) @ K.T
    x1 = x1[:, :2] / x1[:, 2:]
    x1[:n_out] += rng.uniform(20, 80, (n_out, 2))
    inl = np.arange(n) >= n_out
    return x0.astype(np.float32), x1.astype(np.float32), inl


def plane_scene(seed, n_plane=120, n_off=8, noise=0.8, off_noise=0.3,
                t=(1.0, 0.1, 0.2)):
    """Dominant slanted plane plus n_off free points, second camera
    translated by t. Returns (x0, x1, F_true)."""
    rng = np.random.default_rng(seed)
    K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = np.asarray(t, np.float64)
    xy = rng.uniform(-2, 2, (n_plane, 2))
    X = np.r_[np.c_[xy, 5 + 0.3 * xy[:, 0] + 0.2 * xy[:, 1]],
              np.c_[rng.uniform(-2, 2, (n_off, 2)),
                    rng.uniform(2.0, 12.0, n_off)]]

    def proj(X, R, t):
        Xc = X @ R.T + t
        return Xc[:, :2] / Xc[:, 2:3] * [K[0, 0], K[1, 1]] + K[:2, 2]

    sig = np.full(len(X), noise)
    sig[n_plane:] = off_noise
    x0 = proj(X, np.eye(3), np.zeros(3)) + rng.normal(size=(len(X), 2)) * sig[:, None]
    x1 = proj(X, R, t) + rng.normal(size=(len(X), 2)) * sig[:, None]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F_true = np.linalg.inv(K).T @ tx @ R @ np.linalg.inv(K)
    return x0.astype(np.float32), x1.astype(np.float32), F_true


def sampson_np(F, x0, x1):
    x0h = np.c_[x0, np.ones(len(x0))]
    x1h = np.c_[x1, np.ones(len(x1))]
    Fx0 = x0h @ F.T
    Ftx1 = x1h @ F
    num = np.sum(x1h * Fx0, 1) ** 2
    den = Fx0[:, 0] ** 2 + Fx0[:, 1] ** 2 + Ftx1[:, 0] ** 2 + Ftx1[:, 1] ** 2
    return num / np.maximum(den, 1e-12)


def jaccard(a, b) -> float:
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    return float((a & b).sum() / max((a | b).sum(), 1))


def sweep_pair(h: int, w: int, seed: int = 0, shift: float = 5.3):
    """Smooth noise I0 and I1(x) = I0(x - shift): under the sweep's
    convention I0(x) = I1(x - d) the true disparity is d = -shift."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    base = ndi.gaussian_filter(
        rng.uniform(size=(h, w + 40)).astype(np.float32), 2.0)
    xs = np.arange(w) - shift + 20
    x0 = np.floor(xs).astype(int)
    f = xs - x0
    I1 = base[:, x0] * (1 - f) + base[:, x0 + 1] * f
    return (np.ascontiguousarray(base[:, 20:20 + w]),
            np.ascontiguousarray(I1.astype(np.float32)))


def plane_texture(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Band-limited texture of (2h, 2w) in [0, 1], three noise scales."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h * 2, w * 2), np.float32)
    for cell in (6, 12, 24):
        lo = rng.uniform(size=(h * 2 // cell + 1, w * 2 // cell + 1))
        img += cv2.resize(lo.astype(np.float32), (w * 2, h * 2),
                          interpolation=cv2.INTER_CUBIC)
    img -= img.min()
    return img / img.max()


def render_plane(tex: np.ndarray, K: np.ndarray, E: np.ndarray, Z: float,
                 h: int, w: int) -> np.ndarray:
    """The view of camera (K, E) of a fronto-parallel plane Z whose
    albedo is `tex`, spread over world X in [-3, 3] and Y in [-2.5, 2.5],
    rendered with cv2.remap."""
    ys, xs = np.mgrid[0:h, 0:w]
    R = E[:3, :3]
    C = -R.T @ E[:3, 3]
    rays = np.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                     np.ones_like(xs, np.float32)], -1) @ R
    s = (Z - C[2]) / rays[..., 2]
    X = C + s[..., None] * rays
    th, tw = tex.shape
    u = (X[..., 0] + 3.0) / 6.0 * (tw - 1)
    v = (X[..., 1] + 2.5) / 5.0 * (th - 1)
    return cv2.remap(tex, u.astype(np.float32), v.astype(np.float32),
                     cv2.INTER_LINEAR)


def rotation_zyx(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """R = Rz(roll) @ Ry(yaw) @ Rx(pitch), angles in radians."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def stereo_rig(h: int, w: int, f: float, baseline: float, Z: float,
               yaw: float = 0.0, roll: float = 0.0, seed: int = 0):
    """Two cameras looking down +Z at a textured plane Z: camera 0 at the
    origin, camera 1 centred at (baseline, 0, 0), turned by yaw and roll.
    Returns (K, E0, E1, I0, I1) with float32 images in [0, 1]."""
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    E0 = np.eye(4, dtype=np.float32)
    E1 = np.eye(4, dtype=np.float32)
    R1 = rotation_zyx(yaw, 0.0, roll)
    E1[:3, :3] = R1
    E1[:3, 3] = -R1 @ np.array([baseline, 0.0, 0.0], np.float32)
    tex = plane_texture(h, w, seed)
    return (K, E0, E1, render_plane(tex, K, E0, Z, h, w),
            render_plane(tex, K, E1, Z, h, w))
