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
