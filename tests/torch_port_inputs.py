"""Inputs shared by the port's parity tests (tests/test_torch_*.py).

Everything is made with numpy from a seed, so the JAX package and the
PyTorch port receive the same arrays and parameter trees.
"""

from pathlib import Path

import cv2
import numpy as np

REPO_WEIGHTS = Path(__file__).resolve().parents[1] / "weights"

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


def keypoint_sets(b: int, n: int, seed: int, scores: bool = False,
                  size=(640.0, 480.0), dim: int = 256) -> dict:
    """Two random keypoint sets as the JAX package's sharded-matcher
    tests draw them: keypoints uniform over the frame, unit descriptors,
    about 80% of the slots valid, the frame size per pair, and with
    `scores` SuperPoint-like scores in [0, 1)."""
    rng = np.random.default_rng(seed)
    data = {}
    for s in (0, 1):
        kpts = rng.uniform(0, size, (b, n, 2)).astype(np.float32)
        d = rng.normal(size=(b, n, dim)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        data[f"kpts{s}"] = kpts
        data[f"desc{s}"] = d
        if scores:
            data[f"scores{s}"] = rng.uniform(size=(b, n)).astype(np.float32)
        data[f"mask{s}"] = rng.uniform(size=(b, n)) > 0.2
        data[f"size{s}"] = np.broadcast_to(
            np.asarray(size, np.float32), (b, 2)).copy()
    return data


def attention_operands(b: int, h: int, n: int, hd: int, seed: int,
                       p_keep: float | None = 0.7):
    """q, k, v (b, h, n, hd) normal and a key mask (b, n) that keeps
    about p_keep of the keys (None: every key masked)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, n, hd)).astype(np.float32)
               for _ in range(3))
    mask = np.zeros((b, n), bool) if p_keep is None \
        else rng.uniform(size=(b, n)) > 1.0 - p_keep
    return q, k, v, mask


def tiny_sharded_runs(seq_mesh, pp_mesh) -> dict:
    """Ring attention, the sequence-parallel LightGlue (over `seq_mesh`'s
    "seq" axis) and the pipeline-parallel LightGlue (over `pp_mesh`'s
    "pp" axis) of the port at toy sizes on the CPU: 2 layers, 64-d, 2
    heads, 16 tokens. Returns their outputs as numpy arrays; run once in
    each of two processes (the process form) and once in one (the mesh
    form) they must agree."""
    import torch

    from icepy4d_tpu_torch.models.convert import lightglue_params
    from icepy4d_tpu_torch.models.lightglue import LightGlue
    from icepy4d_tpu_torch.parallel import (make_pipeline_parallel_lightglue,
                                            make_ring_attention,
                                            make_sequence_parallel_lightglue)

    def tensors(data):
        return {k: torch.from_numpy(v) for k, v in data.items()}

    lg = LightGlue(n_layers=2, num_heads=2, descriptor_dim=64, input_dim=64,
                   filter_threshold=0.0, device="cpu")
    lg.load_state_dict(lightglue_params(lightglue_tree(2, 64, 2, seed=4)))
    ops = map(torch.from_numpy, attention_operands(1, 2, 16, 8, seed=2))
    out = {"ring": make_ring_attention(seq_mesh)(*ops)}
    sp = make_sequence_parallel_lightglue(seq_mesh, lg)(
        tensors(keypoint_sets(1, 16, seed=6, dim=64)))
    pp = make_pipeline_parallel_lightglue(pp_mesh, lg)(
        tensors(keypoint_sets(2, 16, seed=7, dim=64)))
    out.update({f"sp_{k}": v for k, v in sp.items()})
    out.update({f"pp_{k}": v for k, v in pp.items()})
    return {k: v.numpy() for k, v in out.items()}


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


SEASON_ORIGIN = np.array([500.0, 1200.0, 300.0])   # world position of the scene, m
SEASON_DEPTH = 100.0           # m from the cameras to the rock wall
SEASON_FLOW_PX = 6.0           # px an epoch the glacier tongue moves sideways
SEASON_SEED = 0                # seed of the faces' textures
SEASON_PNG_COMPRESSION = 1     # cv2's fastest PNG setting


def _look_at(C, target) -> np.ndarray:
    """World -> camera rotation of a camera at C looking at `target`
    (world Z up, image y down)."""
    z = np.asarray(target, np.float64) - C
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


class StereoSeason:
    """A synthetic stereo season of a layered, textured scene.

    Two parallel cameras with focal f (px) stand `baseline` m apart
    along X (with `n_cameras=3`, a third stands `baseline` m beyond the
    first, on the side away from the second) and look along +Y at three
    textured faces in a frame with Z up: a rock wall at SEASON_DEPTH (stable ground, it carries the
    targets), a glacier tongue at about 0.9 x that depth that flows
    sideways by SEASON_FLOW_PX pixels an epoch, and two boulders at
    about 0.8 x that depth.
    Each face's depth is set so that its disparity is a multiple of 8 px
    (64, 72 and 80 px at f = 640 px and a baseline of a tenth of the
    depth): the two views of a face differ by a shift of whole 8-px
    cells, which the bundled SuperPoint and LightGlue match to the
    pixel. (Their keypoints follow SuperPoint's 8-px cell grid: under
    any other shift, a half-pixel one or a 1% warp, most matches are off
    by one to seven pixels; and their matches follow the dominant
    motion, so faces whose disparities differ by more than a few cells
    go unmatched. Either is too noisy for a two-view essential matrix.)
    The faces' depths give the pair its parallax. The texture is
    band-limited noise of about `cell_px` px a cell, a different one on each
    face. Frames are ray-cast with torch on `device`, so the same code
    renders the tests' small frames on the CPU and full-size frames on
    the card. World coordinates are the scene's plus SEASON_ORIGIN.
    """

    LABELS = ("T1", "T2", "T3", "T4", "T5")

    def __init__(self, h: int, w: int, f: float, baseline: float = 10.0,
                 cell_px: float = 10.0, device="cpu", n_cameras: int = 2):
        import torch

        self.h, self.w, self.f = h, w, f
        self.depth = depth = SEASON_DEPTH
        flow_px = SEASON_FLOW_PX
        self.device = torch.device(device)
        self.K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                          np.float32)
        # the third camera's baseline to the first (the master of an
        # n-camera season) is the pair's: its disparities are the same
        # whole 8-px cells
        self.centers = np.array([[-baseline / 2, 0.0, 0.0],
                                 [baseline / 2, 0.0, 0.0],
                                 [-1.5 * baseline, 0.0, 0.0]])[:n_cameras]
        self.R = [_look_at(C, C + [0.0, depth, 0.0]) for C in self.centers]
        # faces, far to near, at disparities of whole 8-px cells
        fb = f * baseline
        self.layers = tuple(fb / max(8, 8 * round(fb / (8 * depth * r)))
                            for r in (1.0, 0.9, 0.8))
        self.flow = flow_px * depth / f          # m an epoch, glacier layer
        self.texel = cell_px / 8.0 / f * 100.0   # per 100 m of depth
        # texture square, in m at 100 m of depth: the widest view, the
        # baseline and three epochs of flow
        self.extent = 0.5 * max(w, h) / f * 100.0 + 2 * baseline \
            + 3 * 100.0 / f * flow_px + 4.0
        n = int(2 * self.extent / self.texel) + 8
        g = torch.Generator(device="cpu").manual_seed(SEASON_SEED)
        # one texture per face: a shared texture would repeat across
        # the faces at a constant image offset
        low = torch.rand((1, 3, n // 8 + 3, n // 8 + 3), generator=g)
        self.tex = torch.nn.functional.interpolate(
            low.to(self.device), size=(n, n), mode="bicubic",
            align_corners=True).clamp(0.0, 1.0)

    def _mask(self, k: int, X, Z):
        """Whether scene point (X, Z) of layer k lies on its face."""
        d = self.depth
        if k == 0:
            return X == X
        if k == 1:                                # the tongue
            return (Z.abs() < 0.16 * d) & (X > -0.3 * d) \
                & (X < 0.5 * d)
        return ((X + 0.2 * d) ** 2 + (Z + 0.12 * d) ** 2 < (0.09 * d) ** 2) \
            | ((X - 0.25 * d) ** 2 + (Z - 0.15 * d) ** 2 < (0.07 * d) ** 2)

    def surface_distance(self, P: np.ndarray) -> np.ndarray:
        """Distance (m) of world points to the nearest face they lie on."""
        import torch

        Q = torch.as_tensor(np.asarray(P, np.float64) - SEASON_ORIGIN)
        out = torch.full((len(Q),), float("inf"), dtype=torch.float64)
        for k, Y in enumerate(self.layers):
            on = self._mask(k, Q[:, 0], Q[:, 2])
            out = torch.where(on, torch.minimum(out, (Q[:, 1] - Y).abs()),
                              out)
        return out.numpy()

    def face_index(self, P: np.ndarray) -> np.ndarray:
        """Index of the face (0 rock wall, 1 tongue, 2 boulders) nearest
        to each world point among those it lies on; -1 for none."""
        import torch

        Q = torch.as_tensor(np.asarray(P, np.float64) - SEASON_ORIGIN)
        best = torch.full((len(Q),), float("inf"), dtype=torch.float64)
        idx = torch.full((len(Q),), -1)
        for k, Y in enumerate(self.layers):
            d = (Q[:, 1] - Y).abs()
            closer = self._mask(k, Q[:, 0], Q[:, 2]) & (d < best)
            best = torch.where(closer, d, best)
            idx = torch.where(closer, k, idx)
        return idx.numpy()

    def extrinsics(self, i: int) -> np.ndarray:
        """World -> camera 4x4 of camera i in world coordinates."""
        E = np.eye(4)
        E[:3, :3] = self.R[i]
        E[:3, 3] = -self.R[i] @ (self.centers[i] + SEASON_ORIGIN)
        return E

    def render(self, i: int, epoch: int) -> np.ndarray:
        """Camera i's uint8 frame of the given epoch."""
        import torch

        dev = self.device
        R = torch.tensor(self.R[i], dtype=torch.float32, device=dev)
        C = [float(c) for c in self.centers[i]]
        v, u = torch.meshgrid(torch.arange(self.h, device=dev,
                                           dtype=torch.float32),
                              torch.arange(self.w, device=dev,
                                           dtype=torch.float32),
                              indexing="ij")
        rx = (u - float(self.K[0, 2])) / self.f
        ry = (v - float(self.K[1, 2])) / self.f
        d = [rx * R[0, j] + ry * R[1, j] + R[2, j] for j in range(3)]
        n = self.tex.shape[-1]
        img = None
        for k, Y in enumerate(self.layers):         # far to near
            t = (Y - C[1]) / d[1]
            X, Z = C[0] + t * d[0], C[2] + t * d[2]
            s = 100.0 / Y                           # ~10 px cells
            tx = (X - (self.flow * epoch if k == 1 else 0.0)) * s
            grid = torch.stack([(tx + self.extent) / self.texel,
                                (self.extent - Z * s) / self.texel], -1)
            val = torch.nn.functional.grid_sample(
                self.tex[:, k:k + 1], (grid / (n - 1) * 2 - 1)[None],
                align_corners=True, padding_mode="reflection")[0, 0]
            img = val if img is None else torch.where(
                self._mask(k, X, Z), val, img)
        return (img * 255).round().clamp(0, 255).to(torch.uint8).cpu().numpy()

    def targets(self) -> tuple[np.ndarray, list]:
        """World coordinates (n, 3) of the targets, three on the rock
        wall and one on each boulder (both stable; two depths keep the
        focal length apart from the distance), and each camera's (n, 2)
        pixel coordinates of them; each is checked to be in view and
        unoccluded in every frame."""
        import torch

        d = self.depth
        # three cameras span a wider base: the wall's targets move
        # inwards to stay in every view
        X = np.array([-0.35, 0.4, -0.05, -0.2, 0.25] if len(self.centers) < 3
                     else [-0.3, 0.3, -0.05, -0.2, 0.25]) * d
        Z = np.array([0.3, -0.3, 0.3, -0.12, 0.15]) * d
        k = np.array([0, 0, 0, 2, 2])
        Y = np.array(self.layers)[k]
        P = np.stack([X * Y / d, Y, Z * Y / d], 1)
        px = []
        for i, C in enumerate(self.centers):
            for j in (1, 2):                        # nearer faces
                s = (self.layers[j] - C[1]) / (P[:, 1] - C[1])
                Q = torch.as_tensor(C + s[:, None] * (P - C))
                hit = self._mask(j, Q[:, 0], Q[:, 2]).numpy()
                if np.any(hit & (j > k)):
                    raise ValueError(f"a target is occluded in camera {i}")
            E = self.extrinsics(i)
            Pw = P + SEASON_ORIGIN
            pc = Pw @ E[:3, :3].T + E[:3, 3]
            uv = pc[:, :2] / pc[:, 2:] * self.f + self.K[:2, 2]
            if np.any(uv < 8) or np.any(uv > [self.w - 8, self.h - 8]):
                raise ValueError(f"a target is out of camera {i}'s frame")
            px.append(uv)
        return P + SEASON_ORIGIN, px

    def write(self, root, n_epochs: int = 3, max_keypoints: int = 512,
              options: dict | None = None) -> dict:
        """Write the season (frames with mtimes one hour apart,
        calibrations, target tables) under `root` and return the
        pipeline config that processes it."""
        import csv
        import os
        import time
        from pathlib import Path

        root = Path(root)
        base = time.mktime((2022, 7, 28, 10, 0, 0, 0, 0, -1))
        P, px = self.targets()
        (root / "calib").mkdir(parents=True, exist_ok=True)
        (root / "targets").mkdir(parents=True, exist_ok=True)
        with open(root / "targets" / "target_world.csv", "w",
                  newline="") as fh:
            wr = csv.writer(fh)
            wr.writerow(["label", "X", "Y", "Z"])
            wr.writerows([[lab, *(repr(float(v)) for v in p)]
                          for lab, p in zip(self.LABELS, P)])
        for i in range(len(self.centers)):
            cam = f"cam{i + 1}"
            fx, cx, fy, cy = (float(v) for v in self.K[[0, 0, 1, 1],
                                                      [0, 2, 1, 2]])
            (root / "calib" / f"{cam}.txt").write_text(
                f"{self.w} {self.h} {fx!r} 0 {cx!r} 0 {fy!r} {cy!r} 0 0 1 "
                "0 0 0 0\n")
            d = root / "img" / cam
            d.mkdir(parents=True, exist_ok=True)
            for e in range(n_epochs):
                path = d / f"IMG_{i + 1}{e:03d}.png"
                import cv2 as _cv2

                _cv2.imwrite(str(path), self.render(i, e),
                             [_cv2.IMWRITE_PNG_COMPRESSION,
                              SEASON_PNG_COMPRESSION])
                os.utime(path, (base + 3600 * e, base + 3600 * e))
                with open(root / "targets" / f"{path.stem}.csv", "w",
                          newline="") as fh:
                    wr = csv.writer(fh)
                    wr.writerow(["label", "x", "y"])
                    wr.writerows([[lab, repr(float(x)), repr(float(y))]
                                  for lab, (x, y) in zip(self.LABELS,
                                                         px[i])])
        return {
            "paths": {"image_dir": str(root / "img"),
                      "calibration_dir": str(root / "calib"),
                      "results_dir": str(root / "res")},
            "proc": {"epoch_to_process": "all", "do_orientation": True,
                     "do_ba": True, "do_recovery": True,
                     "do_tracking": False, "do_dense": False,
                     "save_checkpoints": True, "use_mtime_fallback": True},
            "matching": {"matcher": "lightglue", "quality": "high",
                         "tile_selection": "none",
                         "max_keypoints": max_keypoints,
                         "geometric_verification": "pydegensac",
                         "options": dict(options or {})},
            "georef": {"camera_centers_world":
                       (self.centers + SEASON_ORIGIN).tolist(),
                       "target_dir": "targets",
                       "targets_to_use": list(self.LABELS),
                       "target_world_file": "target_world.csv"},
            # the stations' centres are surveyed to 2 cm
            "ba": {"camera_location_accuracy": 0.02},
            "other": {"pydegensac_threshold": 1.0},
        }


def exif_jpeg(path, image: np.ndarray, datetime_original: str,
              make: str = "Canon", model: str = "Canon EOS 6D",
              focal_mm: float = 24.0) -> None:
    """Write `image` as a JPEG whose APP1 segment carries an EXIF block
    built here byte by byte (little-endian TIFF): IFD0 with Make, Model
    and the Exif sub-IFD offset; the sub-IFD with DateTimeOriginal
    ("YYYY:MM:DD HH:MM:SS") and FocalLength (a RATIONAL, 1/1000 mm)."""
    import struct

    def ascii_(s: str) -> bytes:
        return s.encode("ascii") + b"\0"

    strings0 = [(0x010F, ascii_(make)), (0x0110, ascii_(model))]
    n0, n1 = len(strings0) + 1, 2
    ifd0_at = 8
    ifd1_at = ifd0_at + 2 + 12 * n0 + 4
    data_at = ifd1_at + 2 + 12 * n1 + 4
    blob = b""

    def put(b: bytes) -> int:
        nonlocal blob
        at = data_at + len(blob)
        blob += b + (b"\0" if len(b) % 2 else b"")
        return at

    def entry(tag, typ, count, value: bytes) -> bytes:
        if len(value) <= 4:
            return struct.pack("<HHL", tag, typ, count) + value.ljust(4, b"\0")
        return struct.pack("<HHLL", tag, typ, count, put(value))

    ifd0 = [entry(t, 2, len(v), v) for t, v in strings0]
    ifd0.append(entry(0x8769, 4, 1, struct.pack("<L", ifd1_at)))
    dt = ascii_(datetime_original)
    ifd1 = [entry(0x9003, 2, len(dt), dt),
            entry(0x920A, 5, 1, struct.pack("<LL", int(round(
                focal_mm * 1000)), 1000))]
    tiff = (b"II*\0" + struct.pack("<L", ifd0_at)
            + struct.pack("<H", n0) + b"".join(ifd0) + b"\0\0\0\0"
            + struct.pack("<H", n1) + b"".join(ifd1) + b"\0\0\0\0" + blob)
    app1 = b"Exif\0\0" + tiff
    ok, enc = cv2.imencode(".jpg", image)
    if not ok:
        raise ValueError("JPEG encoding failed")
    jpg = enc.tobytes()
    seg = b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1
    Path(path).write_bytes(jpg[:2] + seg + jpg[2:])
