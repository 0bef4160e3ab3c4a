"""The port stands alone: it imports neither JAX nor icepy4d_tpu, and its
default device is the card, never a silent CPU fallback."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "icepy4d_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "icepy4d_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [REPO / "chip_smoke.py",
                            REPO / "scripts" / "profile_torch_match.py",
                            REPO / "scripts" / "degensac_seeds.py",
                            REPO / "scripts" / "time_torch_kernels.py",
                            REPO / "scripts" / "rehearse_seasons_cpu.py",
                            REPO / "scripts" / "loftr_forward_memory.py",
                            REPO / "scripts" / "aliked_extract_memory.py",
                            # the season renderer chip_smoke.py imports
                            REPO / "tests" / "torch_port_inputs.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"   # any import of them raises
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_default_device_raises_without_cuda(no_cuda):
    from icepy4d_tpu_torch.core import PointCloud
    from icepy4d_tpu_torch.matching import (LightGlueMatcher,
                                            NearestNeighborMatcher,
                                            SIFTMatcher,
                                            geometric_verification)
    from icepy4d_tpu_torch.models import SIFT, LightGlue, SuperPoint
    from icepy4d_tpu_torch.sfm import PlaneSweepStereo

    for make in (LightGlueMatcher, NearestNeighborMatcher, SIFTMatcher,
                 SuperPoint, LightGlue, SIFT):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    cloud = PointCloud(points3d=np.zeros((20, 3), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        cloud.sor_filter()
    img = np.zeros((16, 16), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        PlaneSweepStereo([None, None], [img, img], 1.0, 2.0)
    x = np.random.default_rng(0).uniform(0, 100, (20, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        geometric_verification(x, x + 1.0)


def test_cuda_tensor_without_card_raises_not_falls_back(no_cuda):
    """The dispatch takes the plain version only for CPU tensors."""
    from icepy4d_tpu_torch.ops import attention, dense, nms

    meta = torch.zeros((1, 4, 8, 64), device="meta")
    with pytest.raises(ValueError):
        attention.masked_attention(meta, meta, meta,
                                   torch.ones((1, 8), dtype=torch.bool,
                                              device="meta"))
    with pytest.raises(ValueError):
        nms.fused_nms_border(torch.zeros((1, 8, 8), device="meta"),
                             4, 4, 8, 8)
    rect = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError):
        dense.disparity_sweep(rect, rect, 0.0, 4.0, n_disp=5)


def test_geometry_entry_points_raise_without_cuda(no_cuda):
    from icepy4d_tpu_torch.pipeline import Pipeline
    from icepy4d_tpu_torch.sfm import (BundleAdjustment, RelativeOrientation,
                                       Triangulate, estimate_pose)

    x = np.random.default_rng(0).uniform(0, 100, (20, 2)).astype(np.float32)
    K = np.eye(3, dtype=np.float32)
    for make in (lambda: RelativeOrientation([None, None], [x, x]),
                 lambda: Triangulate([None, None], [x, x]),
                 lambda: BundleAdjustment({}, {}, np.zeros((0, 3))),
                 lambda: estimate_pose(x, x, K, K),
                 lambda: Pipeline({"paths": {"image_dir": "img",
                                             "results_dir": "res"}})):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_slice_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """The n-camera Pipeline, space resection, the covariance BA, the
    adaptive matcher and the warping run on the card by default and
    raise without one."""
    import cv2

    from icepy4d_tpu_torch.core import Camera
    from icepy4d_tpu_torch.matching import LightGlueMatcher
    from icepy4d_tpu_torch.pipeline import Pipeline
    from icepy4d_tpu_torch.sfm import (BAConfig, BundleAdjustment,
                                       SpaceResection)
    from icepy4d_tpu_torch.utils.homography import warp_image_to_reference

    img = np.zeros((16, 16), np.uint8)
    for cam in ("cam1", "cam2", "cam3"):
        (tmp_path / "img" / cam).mkdir(parents=True)
        cv2.imwrite(str(tmp_path / "img" / cam / "IMG_0.png"), img)
    cfg = {"paths": {"image_dir": str(tmp_path / "img"),
                     "results_dir": str(tmp_path / "res")},
           "proc": {"do_space_resection": True,
                    "do_homography_warping": True,
                    "use_mtime_fallback": True},
           "other": {"do_viz": True}}
    cam = Camera.create(width=16, height=16, K=np.eye(3))
    for make in (lambda: Pipeline(cfg),
                 lambda: SpaceResection(cam),
                 lambda: BundleAdjustment(
                     {}, {}, np.zeros((0, 3)),
                     cfg=BAConfig(compute_covariance=True)),
                 lambda: LightGlueMatcher({"adaptive": True}),
                 lambda: warp_image_to_reference(img, cam, cam)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_reads_no_file_of_the_jax_package():
    """Importing every module of the port and using its data files (the
    sensor database, the bundled weights, the EXIF scanner's source)
    opens no file under icepy4d_tpu/."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PKG.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import sys, os\n"
        "opened = []\n"
        "def hook(event, args):\n"
        "    if event == 'open' and isinstance(args[0], (str, bytes, "
        "os.PathLike)):\n"
        "        opened.append(os.path.abspath(os.fsdecode(args[0])))\n"
        "sys.addaudithook(hook)\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "from icepy4d_tpu_torch.core import SensorWidthDatabase\n"
        "SensorWidthDatabase().lookup('Canon', 'Canon EOS 6D')\n"
        "from icepy4d_tpu_torch.matching import NearestNeighborMatcher\n"
        "NearestNeighborMatcher({'extractor': 'aliked'}, device='cpu')\n"
        "from icepy4d_tpu_torch.native import native_available\n"
        "native_available()\n"
        f"jax_pkg = os.path.join({str(REPO)!r}, 'icepy4d_tpu') + os.sep\n"
        "bad = sorted({p for p in opened if p.startswith(jax_pkg)})\n"
        "print('ok' if not bad else bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        (out.stdout, out.stderr)


def test_matchers_and_tools_raise_without_cuda(no_cuda):
    """The eighth slice's entry points (the other matchers, extractors
    and models, the OC template matcher, the least-squares Helmert, the
    padded feature structs) run on the card by default."""
    from icepy4d_tpu_torch.core import FeatureSet, PointSet
    from icepy4d_tpu_torch.least_squares import (
        estimate_similarity_least_squares)
    from icepy4d_tpu_torch.matching import (LightGlueMatcher, LoFTRMatcher,
                                            NearestNeighborMatcher,
                                            SemiDenseMatcher,
                                            SuperGlueMatcher, TemplateMatch)
    from icepy4d_tpu_torch.models import ALIKED, DISK, LoFTR, SuperGlue

    img = np.zeros((16, 16), np.float32)
    x = np.random.default_rng(0).uniform(0, 10, (6, 3))
    for make in (SuperGlueMatcher, LoFTRMatcher, SemiDenseMatcher,
                 lambda: LightGlueMatcher({"extractor": "aliked"}),
                 lambda: NearestNeighborMatcher({"extractor": "disk"}),
                 SuperGlue, LoFTR, DISK, ALIKED,
                 lambda: TemplateMatch(img, img, [[8.0, 8.0]]),
                 lambda: estimate_similarity_least_squares(x, x),
                 lambda: FeatureSet.empty(8), lambda: PointSet.empty(8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_product_packages_import_no_optional_host_package():
    """Importing the products (post_processing, utils, io,
    visualization) pulls in none of pandas, matplotlib, h5py or
    rasterio: a machine without them runs every device path."""
    code = (
        "import sys\n"
        "import icepy4d_tpu_torch.post_processing, icepy4d_tpu_torch.utils\n"
        "import icepy4d_tpu_torch.io, icepy4d_tpu_torch.visualization\n"
        "bad = [m for m in ('pandas', 'matplotlib', 'h5py', 'rasterio')\n"
        "       if m in sys.modules]\n"
        "print(bad or 'ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        (out.stdout, out.stderr)


def test_products_raise_without_cuda(no_cuda, tmp_path):
    """The products' device entry points run on the card by default."""
    from icepy4d_tpu_torch.post_processing import (
        DemOfDifference, estimate_normals, geometric_features,
        poisson_reconstruct, voxelize)
    from icepy4d_tpu_torch.utils import (TrackTargets, binned_statistic,
                                         build_dsm)

    x = np.random.default_rng(0).uniform(0, 10, (64, 3)).astype(np.float32)
    img = np.zeros((16, 16), np.uint8)
    for make in (lambda: build_dsm(x), lambda: binned_statistic(x, x[:, 0],
                                                                1.0),
                 lambda: voxelize(x), lambda: geometric_features(x),
                 lambda: estimate_normals(x), lambda: poisson_reconstruct(x),
                 lambda: DemOfDifference(x, x),
                 lambda: TrackTargets(img, [], [[8.0, 8.0]],
                                      out_dir=tmp_path)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_training_imports_no_jax_and_no_cv2():
    """Importing the training package (and its command line) loads no
    JAX, flax, optax or icepy4d_tpu module, and not cv2: only the
    functions that draw, warp or decode import it."""
    code = (
        "import sys\n"
        "import icepy4d_tpu_torch.training\n"
        "import icepy4d_tpu_torch.training.__main__\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('cv2',)!r}]\n"
        "print(bad or 'ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        (out.stdout, out.stderr)


def test_training_entry_points_raise_without_cuda(no_cuda):
    """The trainers run on the card by default and raise without one."""
    from icepy4d_tpu_torch.training import (homographic_adaptation,
                                            homography_to_explicit,
                                            train_superpoint)
    from icepy4d_tpu_torch.training.__main__ import main

    ds = {"H": np.zeros((1, 1, 3, 3), np.float32)}
    for make in (lambda: train_superpoint(steps=1),
                 lambda: homographic_adaptation({}, [], None),
                 lambda: homography_to_explicit(ds),
                 lambda: main(["superpoint", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


COMMAND_ARGS = {
    "run_pipeline": ["config.yaml"],
    "build_dem": ["cloud.ply"],
    "update_dem": ["base.npz", "update.npz"],
    "track_targets": ["--master", "m.jpg", "--images", "*.jpg",
                      "--targets", "t.csv"],
    "volume_variations": ["*.ply"],
    "voxelization": ["*.ply"],
    "extract_section": ["*.ply"],
    "plot_sections": ["*.ply", "--stations", "1"],
    "pcd_rototranslation": ["*.ply"],
    "dynamic_visualization": ["*.ply"],
}


@pytest.mark.parametrize("name", sorted(COMMAND_ARGS)
                         + ["examples.single_epoch_stereo",
                            "examples.multitemporal_4d",
                            "examples.matching_benchmark"])
def test_commands_raise_without_cuda(name, no_cuda, tmp_path):
    """Every command (through `python -m icepy4d_tpu_torch`'s dispatch)
    and walkthrough runs on the card unless given --device cpu: without
    one it raises before reading its inputs, and writes nothing."""
    import importlib

    from icepy4d_tpu_torch.cli import COMMANDS, main

    assert sorted(COMMANDS) == sorted(COMMAND_ARGS)
    if name.startswith("examples."):
        mod = importlib.import_module(f"icepy4d_tpu_torch.{name}")
        run = lambda: mod.main(["--assets", str(tmp_path)])  # noqa: E731
    else:
        run = lambda: main([name, *COMMAND_ARGS[name]])  # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA"):
        run()
    assert not any(tmp_path.iterdir())
