"""The port's command lines (`python -m icepy4d_tpu_torch <command>`)
against the JAX package's scripts on the CPU.

- Product commands: each JAX script runs in-process (`runpy`, argv
  patched) and the port's `main([..., "--device", "cpu"])` on the same
  inputs in a directory of its own; the printed lines are equal (paths
  aside), and the outputs file by file: DSM arrays as
  test_torch_dsm_orthophoto.py holds them (masks and grids equal, z
  within 1e-5), target CSVs as test_torch_products_small.py does
  (labels equal, positions within 1.1e-3 px), the volume CSVs' numbers
  within 1e-5 (the DSMs' float32 sums run in another order), border
  series and voxel rows byte-equal, border, voxel-mesh and transformed
  PLY points equal; the PNG and GIF outputs by count and pixel size.
  Clouds are the glacier front of test_analysis.py, 1800 points scaled
  to 0.1 and centred (the JAX kNN is float32 on raw coordinates,
  ROADMAP section 3).
- `run_pipeline`: each mode reaches its Pipeline method (methods
  patched); a real 2-epoch season from a YAML file equals
  `Pipeline(cfg, device="cpu").run()` in its sinks, statuses and
  points, and so does `--distributed` without a coordinator.
- `python -m icepy4d_tpu_torch --help` lists the ten commands.
"""

import csv
import importlib
import runpy
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from icepy4d_tpu_torch.cli import COMMANDS
from icepy4d_tpu_torch.io.ply import read_ply, write_ply
from torch_port_inputs import REPO_WEIGHTS, StereoSeason

REPO = Path(__file__).resolve().parents[1]
DATES = ("2022_07_28", "2022_07_29", "2022_07_30")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def front_cloud(epoch: int, n: int = 1800):
    """The glacier front of test_analysis.py at a tenth of its size,
    centred; the plateau rises 1 cm an epoch. Colours as uint8."""
    rng = np.random.default_rng(epoch)
    half = n // 2
    top = np.stack([rng.uniform(0, 50, half), rng.uniform(0, 30, half),
                    100.0 + rng.normal(0, 0.05, half)], 1)
    face = np.stack([50.0 + rng.normal(0, 0.05, n - half),
                     rng.uniform(0, 30, n - half),
                     rng.uniform(60, 100, n - half)], 1)
    p = np.concatenate([top, face]) * 0.1 - [2.5, 1.5, 9.0]
    p[:half, 2] += 0.01 * epoch
    rgb = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    return p.astype(np.float32), rgb


def write_clouds(d: Path, n_epochs: int = 3) -> str:
    d.mkdir(parents=True, exist_ok=True)
    for e in range(n_epochs):
        write_ply(d / f"dense_{DATES[e]}.ply", *front_cloud(e))
    return str(d / "dense_*.ply")


def run_both(name: str, argv_of, tmp_path, monkeypatch, capsys,
             prepare=None):
    """Run scripts/<name>.py and the port's command, each with
    `argv_of(side_dir)` after `prepare(side_dir)`; returns {side: (dir,
    stdout with the dir replaced by <dir>, port main's return)}."""
    out = {}
    for side in ("j", "p"):
        d = tmp_path / side
        d.mkdir()
        if prepare is not None:
            prepare(d)
        argv = [str(a) for a in argv_of(d)]
        capsys.readouterr()
        if side == "j":
            script = REPO / "scripts" / f"{name}.py"
            monkeypatch.setattr(sys, "argv", [str(script), *argv])
            runpy.run_path(str(script), run_name="__main__")
            ret = None
        else:
            mod = importlib.import_module(f"icepy4d_tpu_torch.cli.{name}")
            ret = mod.main([*argv, "--device", "cpu"])
        out[side] = (d, capsys.readouterr().out.replace(str(d), "<dir>"),
                     ret)
    same_text(out["p"][1], out["j"][1])
    return out


def same_text(a: str, b: str, rtol: float = 1e-5) -> None:
    """Equal text, but for numbers within `rtol` (float32 sums in
    another order: the DSM tests' 1e-5)."""
    ta, tb = a.replace(",", " ").split(), b.replace(",", " ").split()
    assert len(ta) == len(tb), (a, b)
    for x, y in zip(ta, tb):
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            assert x == y, (a, b)
            continue
        assert fx == pytest.approx(fy, rel=rtol, abs=1e-6, nan_ok=True), \
            (x, y)


def image_sizes(paths) -> list:
    from PIL import Image

    sizes = []
    for p in sorted(paths):
        with Image.open(p) as im:
            sizes.append((p.name, im.size, getattr(im, "n_frames", 1)))
    return sizes


def same_images(dj: Path, dp: Path, pattern: str) -> None:
    sj, sp = image_sizes(dj.glob(pattern)), image_sizes(dp.glob(pattern))
    assert sj and sp == sj


@pytest.mark.parametrize("utm", [False, True], ids=["local", "utm2loc"])
def test_build_dem(utm, tmp_path, monkeypatch, capsys):
    from icepy4d_tpu_torch.utils import belvedere_loc2utm

    def prepare(d):
        p, rgb = front_cloud(0)
        # a UTM cloud keeps float32's 0.5 m steps at 5e6 m; both
        # packages read the same file
        write_ply(d / "cloud.ply", belvedere_loc2utm(p) if utm else p, rgb)

    out = run_both("build_dem", lambda d: [
        d / "cloud.ply", "--step", "0.05", "--out", d / "dem.npz",
        "--geotiff", d / "dem.tif", *(["--utm2loc"] if utm else [])],
        tmp_path, monkeypatch, capsys, prepare)
    a, b = (np.load(out[s][0] / "dem.npz") for s in "jp")
    assert a.files == b.files
    np.testing.assert_array_equal(b["mask"], a["mask"])
    np.testing.assert_allclose(b["z"], a["z"], atol=1e-5, equal_nan=True)
    for k in ("xx", "yy", "res"):
        np.testing.assert_array_equal(b[k], a[k])
    assert b["mask"].sum() > 100
    assert out["p"][2].z.shape == b["z"].shape


def dsm_npz(path, z, xx, yy, res=0.5):
    np.savez_compressed(path, z=z, mask=np.isfinite(z), xx=xx, yy=yy,
                        res=res)


@pytest.mark.parametrize("grid", ["same", "inside"])
def test_update_dem(grid, tmp_path, monkeypatch, capsys):
    """The DoD and merge on one grid, and the coordinate placement of a
    smaller grid inside the base."""
    rng = np.random.default_rng(3)
    base = rng.normal(10.0, 1.0, (40, 60))
    base[rng.uniform(size=base.shape) < 0.1] = np.nan
    xx, yy = 100.0 + 0.5 * np.arange(60), 200.0 + 0.5 * np.arange(40)
    upd = base + rng.normal(0.2, 0.05, base.shape)
    upd[rng.uniform(size=base.shape) < 0.1] = np.nan
    sub = (slice(None), slice(None)) if grid == "same" else \
        (slice(5, 25), slice(12, 42))

    def prepare(d):
        dsm_npz(d / "base.npz", base, xx, yy)
        dsm_npz(d / "update.npz", upd[sub], xx[sub[1]], yy[sub[0]])

    out = run_both("update_dem", lambda d: [
        d / "base.npz", d / "update.npz", "--out", d / "merged.npz"],
        tmp_path, monkeypatch, capsys, prepare)
    assert ("volume added" in out["p"][1]) == (grid == "same")
    a, b = (np.load(out[s][0] / "merged.npz") for s in "jp")
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k])


def test_track_targets(tmp_path, monkeypatch, capsys):
    """The 400x320 pair of test_scripts.py: a frame and its copy moved
    by (3, -2) px."""
    def prepare(d):
        rng = np.random.default_rng(1)
        lo = rng.uniform(size=(40, 50)).astype(np.float32)
        base = cv2.resize(lo, (400, 320), interpolation=cv2.INTER_CUBIC)
        base = (base * 255).astype(np.uint8)
        cv2.imwrite(str(d / "master.jpg"), base)
        M = np.float32([[1, 0, 3], [0, 1, -2]])
        cv2.imwrite(str(d / "slave_0.jpg"), cv2.warpAffine(base, M,
                                                           (400, 320)))
        cv2.imwrite(str(d / "slave_1.jpg"), base)
        (d / "targets.csv").write_text("label,x,y\nT1,150,150\n"
                                       "T2,250,200\nT3,4,4\n")

    out = run_both("track_targets", lambda d: [
        "--master", d / "master.jpg", "--images", d / "slave_*.jpg",
        "--targets", d / "targets.csv", "--out", d / "out",
        "--template", "64", "--search", "96", "--snr", "3"],
        tmp_path, monkeypatch, capsys, prepare)
    for stem in ("slave_0", "slave_1"):
        tj, tp = (list(csv.reader(open(out[s][0] / "out" / f"{stem}.csv")))
                  for s in "jp")
        assert [r[0] for r in tp] == [r[0] for r in tj] == \
            ["label", "T1", "T2"]
        np.testing.assert_allclose(np.float64([r[1:] for r in tp[1:]]),
                                   np.float64([r[1:] for r in tj[1:]]),
                                   atol=1.1e-3)
    res = out["p"][2]["slave_0"]
    np.testing.assert_allclose(res["xy"][:2], [[153, 148], [253, 198]],
                               atol=0.1)


def test_volume_variations(tmp_path, monkeypatch, capsys):
    out = run_both("volume_variations", lambda d: [
        d / "dense_*.ply", "--out", d / "vol", "--tstep", "1",
        "--grid-step", "0.1", "--dir", "z"],
        tmp_path, monkeypatch, capsys, write_clouds)
    dj, dp = (out[s][0] / "vol" for s in "jp")
    names = sorted(p.name for p in dj.glob("*.csv"))
    assert names == sorted(p.name for p in dp.glob("*.csv")) and \
        len(names) == 2
    for n in names + ["parameters.json"]:
        same_text((dp / n).read_text().replace(str(tmp_path / "p"), ""),
                  (dj / n).read_text().replace(str(tmp_path / "j"), ""))
    same_images(dj, dp, "*.png")
    assert len(out["p"][2]) == 2


def test_voxelization(tmp_path, monkeypatch, capsys):
    out = run_both("voxelization", lambda d: [
        d / "dense_*.ply", "--voxel-size", "0.2", "--out", d / "vox",
        "--mesh", "--bb-min", "-3", "-2", "-4", "--bb-max", "3", "2", "2"],
        tmp_path, monkeypatch, capsys,
        lambda d: write_clouds(d, n_epochs=2))
    dj, dp = (out[s][0] / "vox" for s in "jp")
    names = sorted(p.name for p in dj.iterdir())
    assert names == sorted(p.name for p in dp.iterdir()) and \
        len(names) == 4
    for n in names:
        assert (dp / n).read_bytes() == (dj / n).read_bytes(), n
    assert sum(len(g.centers) for g in out["p"][2].values()) > 100


def test_extract_section(tmp_path, monkeypatch, capsys):
    out = run_both("extract_section", lambda d: [
        d / "dense_*.ply", "--out", d / "border", "--k", "16",
        "--x-halfwidth", "1.0"],
        tmp_path, monkeypatch, capsys, write_clouds)
    dj, dp = (out[s][0] / "border" for s in "jp")
    assert (dp / "top_border_coords.txt").read_bytes() == \
        (dj / "top_border_coords.txt").read_bytes()
    for date in DATES:
        a, _ = read_ply(dj / f"border_{date}.ply")
        b, _ = read_ply(dp / f"border_{date}.ply")
        assert len(a)          # top 5% of linearity, then of verticality
        np.testing.assert_array_equal(b, a)


def test_plot_sections(tmp_path, monkeypatch, capsys):
    out = run_both("plot_sections", lambda d: [
        d / "dense_*.ply", "--axis", "y", "--stations", "-0.5", "0.5",
        "--thickness", "0.4", "--out", d / "sections.png"],
        tmp_path, monkeypatch, capsys, write_clouds)
    same_images(out["j"][0], out["p"][0], "sections.png")
    assert len(out["p"][2]) == 6


@pytest.mark.parametrize("mode", ["loc2utm", "utm2loc"])
def test_pcd_rototranslation(mode, tmp_path, monkeypatch, capsys):
    out = run_both("pcd_rototranslation", lambda d: [
        d / "dense_*.ply", "--mode", mode],
        tmp_path, monkeypatch, capsys, lambda d: write_clouds(d, 2))
    suffix = "_utm" if mode == "loc2utm" else "_loc"
    for date in DATES[:2]:
        a, ca = read_ply(out["j"][0] / f"dense_{date}{suffix}.ply")
        b, cb = read_ply(out["p"][0] / f"dense_{date}{suffix}.ply")
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(cb, ca)
    assert len(out["p"][2]) == 2


def test_dynamic_visualization(tmp_path, monkeypatch, capsys):
    def prepare(d):
        write_clouds(d, n_epochs=2)
        write_ply(d / "base.ply", front_cloud(5)[0])
        np.savetxt(d / "poly.csv", [[-3, -2], [3, -2], [3, 1], [-3, 1]],
                   delimiter=",")

    out = run_both("dynamic_visualization", lambda d: [
        d / "dense_*.ply", "--out", d / "viz", "--base", d / "base.ply",
        "--polyline", d / "poly.csv", "--max-points", "500", "--gif"],
        tmp_path, monkeypatch, capsys, prepare)
    dj, dp = (out[s][0] / "viz" for s in "jp")
    same_images(dj, dp, "*.png")
    same_images(dj, dp, "*.gif")
    assert len(out["p"][2]) == 2


# -- run_pipeline --------------------------------------------------------------

MODES = {
    "run": ([], "run", {}),
    "batched": (["--batched"], "run_batched", {}),
    "watch": (["--watch", "--poll-interval", "7.5"], "watch",
              {"poll_interval": 7.5}),
    "distributed": (["--distributed", "--coordinator", "localhost:1234",
                     "--num-processes", "2", "--process-id", "1"],
                    "run_distributed", {}),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_run_pipeline_modes(mode, tmp_path, monkeypatch, capsys):
    """Each mode builds the Pipeline from the config path on the given
    device and calls its method; --distributed first joins the group
    with the given coordinator, size and rank."""
    from icepy4d_tpu_torch import pipeline
    from icepy4d_tpu_torch.cli import run_pipeline
    from icepy4d_tpu_torch.parallel import distributed

    calls = []

    def init(self, cfg, device=None):
        calls.append(("init", str(cfg), device))

    def method(name):
        def call(self, **kw):
            calls.append((name, kw))
            return [None, None, None]
        return call

    monkeypatch.setattr(pipeline.Pipeline, "__init__", init)
    for name in ("run", "run_batched", "watch", "run_distributed"):
        monkeypatch.setattr(pipeline.Pipeline, name, method(name))
    monkeypatch.setattr(distributed, "init_distributed",
                        lambda **kw: calls.append(("init_distributed", kw)))
    flags, name, kw = MODES[mode]
    cfg = str(tmp_path / "config.yaml")
    run_pipeline.main([cfg, *flags, "--device", "cpu"])
    want = [("init", cfg, torch.device("cpu")), (name, kw)]
    if mode == "distributed":
        want.insert(0, ("init_distributed", {
            "coordinator_address": "localhost:1234", "num_processes": 2,
            "process_id": 1, "device": "cpu"}))
    assert calls == want
    assert capsys.readouterr().out == "processed 3 epochs\n"


OPTIONS = {"superpoint_weights": str(REPO_WEIGHTS / "superpoint_synthetic.npz"),
           "lightglue_weights": str(REPO_WEIGHTS / "lightglue_synthetic.npz"),
           "activation_dtype": "float32"}


@pytest.fixture(scope="module")
def season(tmp_path_factory):
    """A 2-epoch 480x640 season (the pipeline parity tests' size) and the
    port's own run() of it."""
    from icepy4d_tpu_torch.pipeline import Pipeline

    root = tmp_path_factory.mktemp("cli_season")
    cfg = StereoSeason(480, 640, 640.0).write(root, n_epochs=2,
                                              max_keypoints=256,
                                              options=OPTIONS)
    cfg["paths"]["results_dir"] = str(root / "ref")
    ref = list(Pipeline(cfg, device="cpu").run())
    return root, cfg, ref


def season_yaml(root: Path, cfg: dict, name: str) -> Path:
    import json

    import yaml

    cfg = json.loads(json.dumps(cfg))        # plain dicts for safe_dump
    cfg["paths"]["results_dir"] = name       # relative to the file
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def same_season(root: Path, name: str, epochs, ref) -> None:
    """Equal statuses, flags, match counts and points; equal CSV sinks
    and checkpoints."""
    assert len(epochs) == len(ref) == 2
    for e, r in zip(epochs, ref):
        assert e.quality["status"] == r.quality["status"] == "ok"
        assert e.quality["flags"] == r.quality["flags"]
        assert e.quality["stats"] == r.quality["stats"]
        np.testing.assert_array_equal(e.points.to_numpy(),
                                      r.points.to_numpy())
    for sink in ("estimated_cameras.csv", "residuals_image.csv"):
        assert (root / name / sink).read_text() == \
            (root / "ref" / sink).read_text()
    ckpt = sorted(p.relative_to(root / "ref")
                  for p in (root / "ref").rglob("*.pickle"))
    assert len(ckpt) == 2 and ckpt == sorted(
        p.relative_to(root / name) for p in (root / name).rglob("*.pickle"))


@pytest.mark.parametrize("flags", [[], ["--distributed"]],
                         ids=["run", "distributed"])
def test_run_pipeline_season(flags, season, monkeypatch, capsys):
    """The command on a YAML file equals run() of the port; with
    --distributed and no coordinator (nor torchrun's variables) it runs
    the season in this one process."""
    from icepy4d_tpu_torch.cli import run_pipeline

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    root, cfg, ref = season
    name = "cli_" + ("_".join(f.strip("-") for f in flags) or "run")
    epochs = run_pipeline.main([str(season_yaml(root, cfg, name)), *flags,
                                "--device", "cpu"])
    assert capsys.readouterr().out == "processed 2 epochs\n"
    same_season(root, name, list(epochs), ref)


def test_help_lists_every_command():
    out = subprocess.run([sys.executable, "-m", "icepy4d_tpu_torch",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    listed = [ln.split()[0] for ln in out.stdout.splitlines()
              if ln.startswith("  ")]
    assert listed == list(COMMANDS) and len(listed) == 10
    for name in COMMANDS:
        assert (REPO / "scripts" / f"{name}.py").exists()


def test_unknown_command_exits():
    from icepy4d_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="unknown command 'build'"):
        main(["build"])
