"""The port's season tools, `Pipeline.warmup` and `Pipeline.watch`,
against the JAX package's on the same 2-epoch synthetic season.

`watch` keeps its books by timestamp: with `stop_after` it returns after
that many epochs, with `max_polls` after that many passes over the
folders; an epoch that arrives late with an earlier timestamp is
processed once, without a tracking seed. No test sleeps: the poll
interval is 0 and the pause between polls is replaced by the arrival of
the late frames, so every loop is bounded by its max_polls.
"""

import logging
import shutil
import time

import numpy as np
import pytest
import torch

from icepy4d_tpu import Pipeline as JPipeline
from icepy4d_tpu.utils.config import DotDict as JDotDict
from icepy4d_tpu_torch.pipeline import Pipeline
from torch_port_inputs import REPO_WEIGHTS, StereoSeason

OPTIONS = {"superpoint_weights": str(REPO_WEIGHTS / "superpoint_synthetic.npz"),
           "lightglue_weights": str(REPO_WEIGHTS / "lightglue_synthetic.npz"),
           "activation_dtype": "float32"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def season(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    cfg = StereoSeason(480, 640, 640.0).write(root / "season", n_epochs=2,
                                              max_keypoints=512,
                                              options=OPTIONS)
    return root, cfg


def _cfg(root, cfg, name: str) -> dict:
    out = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in cfg.items()}
    out["paths"]["results_dir"] = str(root / name)
    out["proc"]["save_checkpoints"] = False
    return out


def _summary(epochs) -> list:
    return [(e.timestamp, e.quality["status"], e.quality["flags"],
             e.quality["stats"]["n_putative"]) for e in epochs]


def _agree(eps, jeps):
    """Same epochs in the same order, statuses, flags and putatives (the
    same f32 computation); RANSAC counts within 3% (two generators)."""
    assert [s[:4] for s in _summary(eps)] == \
        [(j.timestamp, j.quality["status"], j.quality["flags"],
          j.quality["stats"]["n_putative"]) for j in jeps]
    for e, j in zip(eps, jeps):
        for key in ("n_matches", "n_orientation_inliers"):
            js = j.quality["stats"][key]
            assert abs(e.quality["stats"][key] - js) <= 0.03 * js, key


def test_warmup(season):
    """The dummy match builds the extractor for the season's settings
    and leaves no result behind (chip_smoke.py phase 16 runs the season
    after it on the card)."""
    root, cfg = season
    pipe = Pipeline(_cfg(root, cfg, "warm"), device="cpu")
    assert not pipe.matcher._sp_cache
    pipe.warmup()
    assert [k[1] for k in pipe.matcher._sp_cache] == [512]
    assert len(pipe.matcher.mkpts0) == 0 and pipe.matcher.F is None
    assert pipe.matcher.inlier_mask is None


def test_watch_stop_after(season):
    """stop_after=1 processes the earliest epoch and returns."""
    root, cfg = season
    eps = list(Pipeline(_cfg(root, cfg, "w1"), device="cpu").watch(
        poll_interval=0, stop_after=1))
    jeps = list(JPipeline(JDotDict.wrap(_cfg(root, cfg, "j1"))).watch(
        poll_interval=0, stop_after=1))
    assert len(eps) == 1
    _agree(eps, jeps)


def _late_season(root, cfg, name):
    """A copy of the season whose epoch-0 frames are held back; returns
    (config, the function that delivers them)."""
    src = root / "season"
    dst = root / name
    shutil.copytree(src, dst, copy_function=shutil.copy2)
    held = dst / "held"
    held.mkdir()
    for cam in ("cam1", "cam2"):
        for f in (dst / "img" / cam).glob("IMG_?000.png"):
            (held / cam).mkdir(exist_ok=True)
            shutil.move(str(f), str(held / cam / f.name))
    out = _cfg(dst, cfg, "res")
    out["paths"]["image_dir"] = str(dst / "img")
    out["paths"]["calibration_dir"] = str(dst / "calib")

    def arrive(_seconds):
        for cam_dir in held.iterdir():
            for f in cam_dir.iterdir():
                shutil.move(str(f), str(dst / "img" / cam_dir.name / f.name))

    return out, arrive


def test_watch_late_earlier_arrival(season, monkeypatch, caplog):
    """Poll 1 sees only the later epoch; the earlier one arrives before
    poll 2 and is processed then, without a seed; max_polls=2 ends the
    watch. Both packages process the same epochs in the same order."""
    root, cfg = season
    calls = []
    results = {}
    for pkg, make in (("port", lambda c: Pipeline(c, device="cpu")),
                      ("jax", lambda c: JPipeline(JDotDict.wrap(c)))):
        c, arrive = _late_season(root, cfg, f"late_{pkg}")

        def pause(s, arrive=arrive):
            calls.append(s)
            arrive(s)

        monkeypatch.setattr(time, "sleep", pause)
        with caplog.at_level(logging.WARNING):
            results[pkg] = list(make(c).watch(poll_interval=0, max_polls=2))
        monkeypatch.undo()
    assert calls == [0, 0]
    eps, jeps = results["port"], results["jax"]
    assert len(eps) == 2 and eps[0].timestamp > eps[1].timestamp
    _agree(eps, jeps)
    late = [r for r in caplog.records if r.name == "icepy4d_tpu_torch"
            and "out-of-order" in r.getMessage()]
    assert len(late) == 1
    assert np.all([e.quality["status"] == "ok" for e in eps])
