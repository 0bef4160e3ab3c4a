"""SIFT: scale-space detector and gradient-histogram descriptor
(counterpart of `icepy4d_tpu/models/sift.py`, plain PyTorch).

The classic pipeline (Lowe, IJCV 2004) with static shapes: a separable
Gaussian stack per octave with edge-replicated padding, DoG extrema by
a 3x3x3 window max and min, a per-octave top-K of candidates, one
batched Newton step of quadratic subpixel refinement with contrast and
edge rejection, a 36-bin orientation histogram with Lowe's 80% secondary
orientation, the 4x4x8 trilinear descriptor and RootSIFT, then a global
top-K by response over all octaves.

The class holds no weights: its blur kernels and sampling grids live on
an explicit device. Its output has the keys and shapes of
`models/superpoint.py::SuperPoint.extract`. Ties in the top-Ks come out
in `torch.topk`'s order, not `lax.top_k`'s, so keypoint sets are
compared, never slot order.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from icepy4d_tpu_torch.device import full_f32_matmul, resolve_device


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    r = max(int(math.ceil(3.0 * sigma)), 1)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _spatial_bin_weights(n_samp: int, d: int) -> np.ndarray:
    """(n_samp, n_samp, d, d) trilinear spatial weights mapping the sample
    grid onto the d x d descriptor cells."""
    pos = (np.arange(n_samp) + 0.5) / n_samp * d - d / 2.0
    cbin = pos + d / 2.0 - 0.5  # continuous cell index
    w = np.zeros((n_samp, d), np.float32)
    for i, c in enumerate(cbin):
        c0 = int(np.floor(c))
        f = c - c0
        if 0 <= c0 < d:
            w[i, c0] = 1.0 - f
        if 0 <= c0 + 1 < d:
            w[i, c0 + 1] = f
    return np.einsum("ya,xb->yxab", w, w).astype(np.float32)


def _blur(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of (B, H, W), edges replicated."""
    r = (kern.numel() - 1) // 2
    x = F.pad(img[:, None], (0, 0, r, r), mode="replicate")
    with full_f32_matmul():
        x = F.conv2d(x, kern.view(1, 1, -1, 1))
        x = F.pad(x, (r, r, 0, 0), mode="replicate")
        x = F.conv2d(x, kern.view(1, 1, 1, -1))
    return x[:, 0]


def _upsample2x(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, 2H, 2W) linear. For a factor of 2 the clamped
    source coordinate of `align_corners=False` gives the edge weights
    that `jax.image.resize(..., "linear")` renormalises to."""
    b, h, w = img.shape
    return F.interpolate(img[:, None], size=(2 * h, 2 * w), mode="bilinear",
                         align_corners=False)[:, 0]


def _linspace(n: int) -> np.ndarray:
    return np.linspace(-1.0, 1.0, n).astype(np.float32)


class SIFT:
    """Parameter-free scale-invariant feature transform.

    Options as cv2.SIFT's: n_octave_layers (3), contrast_threshold
    (0.04), edge_threshold (10), sigma (1.6); `upsample` doubles the
    image before the first octave; `root_sift` applies the Hellinger
    normalisation; `dual_orientation` adds a second descriptor where a
    second histogram peak reaches 80% of the first.
    """

    _N_SAMP = 16       # descriptor sample grid (4 cells x 4 samples)
    _N_ORI = 36
    _P_ORI = 13        # orientation sample grid

    def __init__(self, max_keypoints: int = 4096, n_octave_layers: int = 3,
                 contrast_threshold: float = 0.04,
                 edge_threshold: float = 10.0, sigma: float = 1.6,
                 upsample: bool = True, root_sift: bool = True,
                 descriptor_dim: int = 128, ori_radius: float = 2.5,
                 ori_sigma: float = 0.67, desc_radius: float = 4.5,
                 desc_sigma: float = 0.6, dual_orientation: bool = True,
                 device=None):
        if descriptor_dim != 128:
            raise ValueError("SIFT descriptors are 128-d")
        self.device = resolve_device(device)
        self.max_keypoints = int(max_keypoints)
        self.n_octave_layers = int(n_octave_layers)
        self.contrast_threshold = float(contrast_threshold)
        self.edge_threshold = float(edge_threshold)
        self.sigma = float(sigma)
        self.upsample = bool(upsample)
        self.root_sift = bool(root_sift)
        self.ori_radius = float(ori_radius)
        self.ori_sigma = float(ori_sigma)
        self.desc_radius = float(desc_radius)
        self.desc_sigma = float(desc_sigma)
        self.dual_orientation = bool(dual_orientation)

        s = self.n_octave_layers
        k = 2.0 ** (1.0 / s)
        # incremental blur kernels: sigma_total(i) = sigma * k^i
        dev = self.device
        self._inc_kernels = []
        prev = self.sigma
        for i in range(1, s + 3):
            tot = self.sigma * (k ** i)
            inc = math.sqrt(max(tot * tot - prev * prev, 1e-8))
            self._inc_kernels.append(
                torch.from_numpy(_gaussian_kernel1d(inc)).to(dev))
            prev = tot
        self._sigmas = torch.tensor(
            np.array([self.sigma * (k ** i) for i in range(s + 3)],
                     np.float32), device=dev)
        # the input's assumed blur is 0.5 px, 1 px once upsampled
        base_blur = math.sqrt(max(
            self.sigma ** 2 - (1.0 if self.upsample else 0.25), 0.01))
        self._base_kernel = torch.from_numpy(
            _gaussian_kernel1d(base_blur)).to(dev)
        self._spatial = torch.from_numpy(
            _spatial_bin_weights(self._N_SAMP, 4)).to(dev)
        self._u_ori = torch.from_numpy(_linspace(self._P_ORI)).to(dev)
        self._u_desc = torch.from_numpy(_linspace(self._N_SAMP)).to(dev)

    # -- per-octave detection -------------------------------------------------

    def _octave(self, base: torch.Tensor):
        """One octave of (B, H, W) `base`: the Gaussian stack (B, s+3, H,
        W) and the per-image top-K refined candidates (x, y, level in
        0..s-1, |contrast|, valid)."""
        s = self.n_octave_layers
        b, h, w = base.shape
        gs = [base]
        for kern in self._inc_kernels:
            gs.append(_blur(gs[-1], kern))
        G = torch.stack(gs, 1)                          # (B, s+3, H, W)
        del gs
        D = G[:, 1:] - G[:, :-1]                        # (B, s+2, H, W)

        # 26-neighbour extremum test on the s middle DoG levels
        D5 = D[:, None]
        win_max = F.max_pool3d(D5, 3, 1, (0, 1, 1))[:, 0]     # (B, s, H, W)
        win_min = -F.max_pool3d(-D5, 3, 1, (0, 1, 1))[:, 0]
        mid = D[:, 1:s + 1]
        thresh = 0.5 * self.contrast_threshold / s
        is_ext = ((mid >= win_max) & (mid > thresh)) | \
            ((mid <= win_min) & (mid < -thresh))
        del win_max, win_min
        # keep off the 5-px border (the descriptor window needs it anyway)
        is_ext[..., :5, :] = False
        is_ext[..., h - 5:, :] = False
        is_ext[..., :5] = False
        is_ext[..., w - 5:] = False
        resp = torch.where(is_ext, mid.abs(), 0.0)
        del is_ext
        top_resp, top_idx = torch.topk(resp.reshape(b, -1),
                                       self.max_keypoints)
        del resp
        si = top_idx // (h * w)
        yi = (top_idx // w) % h
        xi = top_idx % w
        valid = top_resp > 0.0

        # quadratic subpixel refinement, one batched Newton step over
        # (x, y, s); DoG level of a candidate = si + 1
        bi = torch.arange(b, device=base.device)[:, None]

        def at(ds, dy, dx):
            return D[bi, si + 1 + ds, (yi + dy).clamp(0, h - 1),
                     (xi + dx).clamp(0, w - 1)]

        v = at(0, 0, 0)
        gx = 0.5 * (at(0, 0, 1) - at(0, 0, -1))
        gy = 0.5 * (at(0, 1, 0) - at(0, -1, 0))
        gss = 0.5 * (at(1, 0, 0) - at(-1, 0, 0))
        hxx = at(0, 0, 1) + at(0, 0, -1) - 2 * v
        hyy = at(0, 1, 0) + at(0, -1, 0) - 2 * v
        hss = at(1, 0, 0) + at(-1, 0, 0) - 2 * v
        hxy = 0.25 * (at(0, 1, 1) - at(0, 1, -1)
                      - at(0, -1, 1) + at(0, -1, -1))
        hxs = 0.25 * (at(1, 0, 1) - at(1, 0, -1)
                      - at(-1, 0, 1) + at(-1, 0, -1))
        hys = 0.25 * (at(1, 1, 0) - at(1, -1, 0)
                      - at(-1, 1, 0) + at(-1, -1, 0))
        del D
        Hm = torch.stack([
            torch.stack([hxx, hxy, hxs], -1),
            torch.stack([hxy, hyy, hys], -1),
            torch.stack([hxs, hys, hss], -1)], -2)      # (B, K, 3, 3)
        g = torch.stack([gx, gy, gss], -1)
        Hm = Hm + 1e-6 * torch.eye(3, device=base.device)
        # solve_ex: a singular system of a padded slot must not raise
        off = -torch.linalg.solve_ex(Hm, g[..., None])[0][..., 0]
        off = off.clamp(-0.6, 0.6)
        contrast = v + 0.5 * torch.sum(g * off, -1)
        valid &= contrast.abs() * s >= self.contrast_threshold
        # edge rejection on the 2x2 spatial Hessian
        tr = hxx + hyy
        det = hxx * hyy - hxy * hxy
        r = self.edge_threshold
        valid &= (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
        xf = xi + off[..., 0]
        yf = yi + off[..., 1]
        return G, xf, yf, si, contrast.abs(), valid

    # -- orientation + descriptor ---------------------------------------------

    @staticmethod
    def _sampler(G: torch.Tensor, lvl: torch.Tensor):
        """Bilinear sampling of each keypoint's Gaussian level of G
        (B, L, H, W); ys, xs (B, K, P, P)."""
        b, _, h, w = G.shape
        bi = torch.arange(b, device=G.device)[:, None, None, None]
        lv = lvl[:, :, None, None]

        def sample(ys, xs):
            y0 = torch.floor(ys)
            x0 = torch.floor(xs)
            fy = ys - y0
            fx = xs - x0
            y0c = y0.long().clamp(0, h - 2)
            x0c = x0.long().clamp(0, w - 2)

            def g(dy, dx):
                return G[bi, lv, y0c + dy, x0c + dx]

            return ((1 - fy) * (1 - fx) * g(0, 0)
                    + (1 - fy) * fx * g(0, 1)
                    + fy * (1 - fx) * g(1, 0)
                    + fy * fx * g(1, 1))

        return sample

    @staticmethod
    def _gradients(vals: torch.Tensor, step: torch.Tensor):
        """Central differences on the (.., P, P) sample grid (one-sided at
        its edges), per pixel of the image."""
        step = step.clamp_min(1e-6)
        gx = torch.gradient(vals, dim=3)[0] / step
        gy = torch.gradient(vals, dim=2)[0] / step
        return gx, gy

    def _describe(self, G: torch.Tensor, xf, yf, si, valid):
        """Orientation(s) and 4x4x8 descriptors of one octave's keypoints.
        Returns ((desc1, desc2 or None), valid2)."""
        b, k = xf.shape
        lvl = si + 1
        sig = self._sigmas[lvl]                        # (B, K)
        sample = self._sampler(G, lvl)
        two_pi = 2 * math.pi
        n_ori = self._N_ORI

        # ---- orientation: 36-bin histogram on an axis-aligned grid ----
        p_ori = self._P_ORI
        vv, uu = torch.meshgrid(self._u_ori, self._u_ori, indexing="ij")
        rr = sig[..., None, None] * self.ori_radius    # (B, K, 1, 1)
        vals = sample(yf[..., None, None] + vv * rr,
                      xf[..., None, None] + uu * rr)
        gx, gy = self._gradients(vals, rr * (2.0 / (p_ori - 1)))
        mag = torch.sqrt(gx * gx + gy * gy)
        ang = torch.atan2(gy, gx)
        wgt = torch.exp(-(uu ** 2 + vv ** 2) / (2 * self.ori_sigma ** 2))
        bin_f = (ang / two_pi + 0.5) * n_ori
        fl = torch.floor(bin_f)
        b0 = fl.long() % n_ori
        fb = bin_f - fl
        mw = (mag * wgt).reshape(b, k, -1)
        fb = fb.reshape(b, k, -1)
        b0 = b0.reshape(b, k, -1)
        hist = torch.zeros((b, k, n_ori), device=G.device)
        hist.scatter_add_(-1, b0, mw * (1 - fb))
        hist.scatter_add_(-1, (b0 + 1) % n_ori, mw * fb)
        # circular smoothing x2
        for _ in range(2):
            hist = (torch.roll(hist, 1, -1) + hist
                    + torch.roll(hist, -1, -1)) / 3.0

        def peak_theta(hh):
            peak = torch.argmax(hh, -1, keepdim=True)
            # parabolic interpolation on the unmasked histogram
            hl = torch.gather(hist, -1, (peak - 1) % n_ori)[..., 0]
            hc = torch.gather(hist, -1, peak)[..., 0]
            hr = torch.gather(hist, -1, (peak + 1) % n_ori)[..., 0]
            denom = hl - 2 * hc + hr
            dpk = torch.where(denom.abs() > 1e-8,
                              0.5 * (hl - hr) / (denom + 1e-12), 0.0)
            theta = ((peak[..., 0] + dpk) / n_ori - 0.5) * 2 * math.pi
            return theta, peak[..., 0], hc

        theta1, peak1, h1 = peak_theta(hist)
        # secondary orientation: mask +-2 bins round the primary
        bins = torch.arange(n_ori, device=G.device)
        dist = ((bins - peak1[..., None] + n_ori // 2) % n_ori
                - n_ori // 2).abs()
        theta2, _, h2 = peak_theta(
            torch.where(dist <= 2, -torch.inf, hist))
        valid2 = valid & (h2 >= 0.8 * h1)

        # ---- descriptor: rotated 16x16 sample grid -> 4x4x8 ----
        p = self._N_SAMP
        n_bins = 8
        vv2, uu2 = torch.meshgrid(self._u_desc, self._u_desc, indexing="ij")
        rr2 = sig[..., None, None] * self.desc_radius
        wgtd = torch.exp(-(uu2 ** 2 + vv2 ** 2) / (2 * self.desc_sigma ** 2))
        sw = self._spatial.reshape(p * p, 16)

        def describe_at(theta, val):
            ct = torch.cos(theta)[..., None, None]
            st = torch.sin(theta)[..., None, None]
            xr = (uu2 * ct - vv2 * st) * rr2
            yr = (uu2 * st + vv2 * ct) * rr2
            vals2 = sample(yf[..., None, None] + yr, xf[..., None, None] + xr)
            gxr, gyr = self._gradients(vals2, rr2 * (2.0 / (p - 1)))
            magd = torch.sqrt(gxr * gxr + gyr * gyr)
            angd = torch.atan2(gyr, gxr)               # rotated frame
            bf = (angd / two_pi + 0.5) * n_bins
            fl2 = torch.floor(bf)
            bf0 = fl2.long() % n_bins
            fb2 = (bf - fl2)[..., None]
            oh0 = F.one_hot(bf0, n_bins).float()
            oh1 = F.one_hot((bf0 + 1) % n_bins, n_bins).float()
            contrib = (magd * wgtd)[..., None] * (oh0 * (1 - fb2)
                                                  + oh1 * fb2)
            # spatial binning: (P*P, 16) x (P*P, 8) per keypoint
            with full_f32_matmul():
                desc = torch.matmul(sw.T, contrib.reshape(b * k, p * p,
                                                          n_bins))
            desc = desc.reshape(b, k, 16 * n_bins)
            # L2 -> clip 0.2 -> L2 (-> RootSIFT)
            desc = desc / torch.linalg.vector_norm(
                desc, dim=-1, keepdim=True).clamp_min(1e-12)
            desc = desc.clamp_max(0.2)
            desc = desc / torch.linalg.vector_norm(
                desc, dim=-1, keepdim=True).clamp_min(1e-12)
            if self.root_sift:
                desc = torch.sqrt(desc / desc.sum(-1, keepdim=True)
                                  .clamp_min(1e-12))
            return torch.where(val[..., None], desc, 0.0)

        desc1 = describe_at(theta1, valid)
        if not self.dual_orientation:
            return (desc1, None), valid2
        return (desc1, describe_at(theta2, valid2)), valid2

    # -- public API -----------------------------------------------------------

    @torch.inference_mode()
    def extract(self, images: torch.Tensor) -> dict:
        """images: (B, H, W) or (B, H, W, 1) grayscale in [0, 1].

        Returns {keypoints (B,K,2) xy px, descriptors (B,K,128), scores
        (B,K), mask (B,K)} with K = max_keypoints, in the image's pixel
        frame.
        """
        img = images.to(self.device, torch.float32)
        if img.ndim == 4:
            img = img[..., 0]
        return self._extract(img)

    def _base_image(self, img: torch.Tensor) -> tuple[torch.Tensor, float]:
        """The first octave's base image (2x upsampled when `upsample`)
        and its pixel scale relative to `img`."""
        if self.upsample:
            return _blur(_upsample2x(img), self._base_kernel), 0.5
        return _blur(img, self._base_kernel), 1.0

    def _extract(self, img: torch.Tensor) -> dict:
        base, scale0 = self._base_image(img)
        n_oct = max(int(math.log2(min(base.shape[1:])) - 3), 1)
        n_oct = min(n_oct, 5)

        all_k, all_d, all_s, all_v = [], [], [], []
        for o in range(n_oct):
            G, xf, yf, si, resp, valid = self._octave(base)
            (d1, d2), valid2 = self._describe(G, xf, yf, si, valid)
            sc = scale0 * (2.0 ** o)
            kpts = torch.stack([xf * sc, yf * sc], -1)
            all_k.append(kpts)
            all_d.append(d1)
            all_s.append(torch.where(valid, resp, 0.0))
            all_v.append(valid)
            if d2 is not None:
                # same location, second descriptor, a score just below
                # so that the global top-K prefers primaries on ties
                all_k.append(kpts)
                all_d.append(d2)
                all_s.append(torch.where(valid2, resp * 0.999, 0.0))
                all_v.append(valid2)
            if o + 1 < n_oct:
                # next octave: level s (twice the base sigma), every 2nd px
                base = G[:, self.n_octave_layers, ::2, ::2].contiguous()
            del G

        scores = torch.cat(all_s, 1)
        top_s, top_i = torch.topk(scores, self.max_keypoints)
        kpts = torch.gather(torch.cat(all_k, 1), 1,
                            top_i[..., None].expand(-1, -1, 2))
        desc = torch.cat(all_d, 1)
        desc = torch.gather(desc, 1,
                            top_i[..., None].expand(-1, -1, desc.shape[-1]))
        mask = torch.gather(torch.cat(all_v, 1), 1, top_i) & (top_s > 0)
        return {"keypoints": kpts, "descriptors": desc, "scores": top_s,
                "mask": mask}
