"""Synthetic stereo frames rendered on the card from a seed.

A copy of the renderer of `tests/torch_port_inputs.py::StereoSeason`
(geometry, faces and texture unchanged), cut to what the benchmark
needs: the texture is drawn from the run's seed instead of a fixed one,
and frames stay on the device until the caller copies them.

Two parallel cameras with focal f (px) stand `baseline` m apart along X
and look along +Y at three textured faces: a rock wall at DEPTH, a
glacier tongue at about 0.9 x that depth flowing sideways by FLOW_PX a
epoch, and two boulders at about 0.8 x that depth. Each face's depth
puts its disparity on a whole number of 8-px cells, which the bundled
SuperPoint and LightGlue match to the pixel; the texture is band-limited
noise of about `cell_px` px a cell, a different one on each face.
"""

from __future__ import annotations

import numpy as np
import torch

DEPTH = 100.0           # m from the cameras to the rock wall
FLOW_PX = 6.0           # px an epoch the glacier tongue moves sideways


def _look_at(C, target) -> np.ndarray:
    """World -> camera rotation of a camera at C looking at `target`
    (world Z up, image y down)."""
    z = np.asarray(target, np.float64) - C
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def cameras(h: int, w: int, f: float, baseline: float) -> tuple:
    """(K, centres (2, 3), [R0, R1]) of the two parallel cameras."""
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)
    centers = np.array([[-baseline / 2, 0.0, 0.0], [baseline / 2, 0.0, 0.0]])
    return K, centers, [_look_at(C, C + [0.0, DEPTH, 0.0]) for C in centers]


def fundamental(traffic: dict) -> np.ndarray:
    """The pair's true fundamental matrix (x1^T F x0 = 0 for pixels x0 of
    camera 0 and x1 of camera 1), from the cameras' known poses."""
    K, C, R = cameras(traffic["height"], traffic["width"],
                      traffic["focal_px"], traffic["baseline_m"])
    rel = R[1] @ R[0].T
    t = R[1] @ (C[0] - C[1])
    tx = np.array([[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]],
                   [-t[1], t[0], 0.0]])
    Kinv = np.linalg.inv(K)
    return Kinv.T @ tx @ rel @ Kinv


class StereoScene:
    def __init__(self, h: int, w: int, f: float, baseline: float,
                 cell_px: float, seed: int, device):
        self.h, self.w, self.f = h, w, f
        self.device = torch.device(device)
        K, self.centers, self.R = cameras(h, w, f, baseline)
        self.K = K.astype(np.float32)
        fb = f * baseline
        self.layers = tuple(fb / max(8, 8 * round(fb / (8 * DEPTH * r)))
                            for r in (1.0, 0.9, 0.8))
        self.flow = FLOW_PX * DEPTH / f
        self.texel = cell_px / 8.0 / f * 100.0
        self.extent = 0.5 * max(w, h) / f * 100.0 + 2 * baseline \
            + 3 * 100.0 / f * FLOW_PX + 4.0
        n = int(2 * self.extent / self.texel) + 8
        g = torch.Generator(device=self.device).manual_seed(seed)
        low = torch.rand((1, 3, n // 8 + 3, n // 8 + 3), generator=g,
                         device=self.device)
        self.tex = torch.nn.functional.interpolate(
            low, size=(n, n), mode="bicubic", align_corners=True).clamp(0, 1)

    def _mask(self, k: int, X, Z):
        d = DEPTH
        if k == 0:
            return X == X
        if k == 1:
            return (Z.abs() < 0.16 * d) & (X > -0.3 * d) & (X < 0.5 * d)
        return ((X + 0.2 * d) ** 2 + (Z + 0.12 * d) ** 2 < (0.09 * d) ** 2) \
            | ((X - 0.25 * d) ** 2 + (Z - 0.15 * d) ** 2 < (0.07 * d) ** 2)

    def render(self, i: int, epoch: int) -> torch.Tensor:
        """Camera i's uint8 (h, w) frame of the given epoch, on the device."""
        dev = self.device
        R = torch.tensor(self.R[i], dtype=torch.float32, device=dev)
        C = [float(c) for c in self.centers[i]]
        v, u = torch.meshgrid(
            torch.arange(self.h, device=dev, dtype=torch.float32),
            torch.arange(self.w, device=dev, dtype=torch.float32),
            indexing="ij")
        rx = (u - float(self.K[0, 2])) / self.f
        ry = (v - float(self.K[1, 2])) / self.f
        d = [rx * R[0, j] + ry * R[1, j] + R[2, j] for j in range(3)]
        n = self.tex.shape[-1]
        img = None
        for k, Y in enumerate(self.layers):
            t = (Y - C[1]) / d[1]
            X, Z = C[0] + t * d[0], C[2] + t * d[2]
            s = 100.0 / Y
            tx = (X - (self.flow * epoch if k == 1 else 0.0)) * s
            grid = torch.stack([(tx + self.extent) / self.texel,
                                (self.extent - Z * s) / self.texel], -1)
            val = torch.nn.functional.grid_sample(
                self.tex[:, k:k + 1], (grid / (n - 1) * 2 - 1)[None],
                align_corners=True, padding_mode="reflection")[0, 0]
            img = val if img is None else torch.where(
                self._mask(k, X, Z), val, img)
        return (img * 255).round().clamp(0, 255).to(torch.uint8)


def pair_seed(seed: int, index: int) -> int:
    """Texture seed of the run's pair `index`: distinct pairs, one run
    seed (any whole number, also past 32 bits) to one set of pairs."""
    return (int(seed) * 1_000_003 + index) % (2 ** 63 - 1)


def render_pairs(traffic: dict, seed: int, device) -> list:
    """The traffic's `pairs` distinct stereo pairs as host uint8 arrays
    [(cam1, cam2), ...], each from its own texture."""
    out = []
    for j in range(int(traffic["pairs"])):
        scene = StereoScene(traffic["height"], traffic["width"],
                            traffic["focal_px"], traffic["baseline_m"],
                            traffic["cell_px"], pair_seed(seed, j), device)
        frames = [scene.render(i, 0) for i in range(2)]
        out.append(tuple(f.cpu().numpy() for f in frames))
        del scene
    return out
