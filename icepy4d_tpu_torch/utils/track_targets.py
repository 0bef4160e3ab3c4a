"""Multi-epoch target (GCP) tracking by OC template matching
(counterpart of `icepy4d_tpu/utils/track_targets.py`).

Surveyed targets are tracked from one master image into every slave
image of the season, filtered by SNR, and written as per-image CSVs
that `Targets` reads. Each slave image is one batched device call over
all targets (`matching/templatematch.py::oc_track`); the master's
orientation image is computed once.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from icepy4d_tpu_torch.device import resolve_device
from icepy4d_tpu_torch.matching.templatematch import forient, oc_track

logger = logging.getLogger("icepy4d_tpu_torch")


def _read_gray(src) -> np.ndarray:
    """float32 gray image of an array (RGB converted), an `Image` or a
    path."""
    import cv2

    if isinstance(src, np.ndarray):
        img = src
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        return img.astype(np.float32)
    path = getattr(src, "path", src)
    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path}")
    return img.astype(np.float32)


class TrackTargets:
    """Track `targets` (n, 2) from `master` into each image of `images`
    on `device` (None: the card).

    config keys: template_width 32, search_width 128, snr_threshold 7.0,
    verbose False.
    """

    def_config = {
        "template_width": 32,
        "search_width": 128,
        "snr_threshold": 7.0,
        "verbose": False,
    }

    def __init__(
        self,
        master,
        images: list,
        targets: np.ndarray,
        method: str = "OC",
        out_dir: str = "results",
        target_names: list[str] | None = None,
        device=None,
        **config,
    ) -> None:
        targets = np.asarray(targets, np.float64).reshape(-1, 2)
        if method != "OC":
            raise ValueError("only OC is supported")
        self.device = resolve_device(device)
        self.cfg = {**self.def_config, **config}
        self.images = images
        self.targets = targets
        self.target_names = target_names or [
            f"target_{i}" for i in range(len(targets))]
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._master = _read_gray(master)
        self._master_or = forient(torch.from_numpy(self._master).to(
            self.device))
        self.results: dict[str, dict] = {}

    def track_image(self, slave) -> dict:
        """Track all targets into one slave image (one device call)."""
        name = getattr(slave, "name", None) or Path(
            getattr(slave, "path", slave)).name
        stem = Path(name).stem
        slave_or = forient(torch.from_numpy(_read_gray(slave)).to(
            self.device))
        res = oc_track(
            self._master_or, slave_or, self.targets,
            template_width=self.cfg["template_width"],
            search_width=self.cfg["search_width"],
        )
        snr = res.snr
        ok = np.isfinite(res.du) & (snr > self.cfg["snr_threshold"])
        xy = np.stack([res.pu + res.du, res.pv + res.dv], -1)
        out = {
            "xy": np.where(ok[:, None], xy, np.nan),
            "snr": snr,
            "ok": ok,
        }
        self.results[stem] = out
        if self.cfg["verbose"]:
            logger.info("%s: tracked %d/%d targets (SNR>%s)",
                        stem, int(ok.sum()), len(ok),
                        self.cfg["snr_threshold"])
        self._write_csv(stem, out)
        return out

    def _write_csv(self, stem: str, out: dict) -> None:
        """Per-image CSV (label,x,y) readable by core.Targets."""
        path = self.out_dir / f"{stem}.csv"
        with open(path, "w") as f:
            f.write("label,x,y\n")
            for lab, (x, y), ok in zip(
                    self.target_names, out["xy"], out["ok"]):
                if ok:
                    f.write(f"{lab},{x:.4f},{y:.4f}\n")

    def track(self) -> dict[str, dict]:
        """Track every slave image, one device call an image."""
        for im in self.images:
            self.track_image(im)
        return self.results
