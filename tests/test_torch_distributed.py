"""The multi-process season and the staged pipeline against the JAX
package: the epoch partition equal for every shape, `all_gather_host`,
two real gloo processes (collectives and a tracked season split in two),
`run_distributed` on one process equal to `run`, and `StagedPipeline`
equal to sequential calls."""

import copy
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from icepy4d_tpu.parallel import partition_epochs as jpartition
from icepy4d_tpu.parallel import split_devices as jsplit
from icepy4d_tpu_torch.models.convert import load_params, superpoint_state_dict
from icepy4d_tpu_torch.models.superpoint import SuperPointNet
from icepy4d_tpu_torch.parallel import (EpochShard, StagedPipeline,
                                        all_gather_host, global_mesh,
                                        partition_epochs, split_devices)
from icepy4d_tpu_torch.pipeline import Pipeline
from torch_port_inputs import REPO_WEIGHTS, StereoSeason

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several test files at once
    on a few cores, and full-width thread pools in each of them slow
    every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the epoch partition and the host gather -------------------------------

def test_partition_epochs_equals_jax():
    for n in range(13):
        for pc in range(1, 6):
            shards = [partition_epochs(n, pi, pc) for pi in range(pc)]
            for pi, s in enumerate(shards):
                j = jpartition(n, pi, pc)
                assert (s.start, s.stop) == (j.start, j.stop)
            assert [i for s in shards for i in s.indices] == list(range(n))


def test_single_process_defaults():
    s = partition_epochs(7)
    assert isinstance(s, EpochShard) and list(s.indices) == list(range(7))
    out = all_gather_host({"a": np.arange(3.0), "b": [np.ones((2, 2), bool)]})
    assert out["a"].shape == (1, 3) and out["b"][0].shape == (1, 2, 2)
    np.testing.assert_array_equal(out["a"][0], np.arange(3.0))
    assert global_mesh().shape == {"epoch": 1, "data": 1}


# -- two gloo processes --------------------------------------------------------

_WORKER = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from icepy4d_tpu_torch.parallel import (all_gather_host, global_mesh,
                                            init_distributed,
                                            partition_epochs)
    from icepy4d_tpu_torch.pipeline import Pipeline

    rank = int(sys.argv[1])
    assert init_distributed(coordinator_address="localhost:{port}",
                            num_processes=2, process_id=rank, device="cpu")
    mesh = global_mesh()
    assert mesh.shape == {{"epoch": 2, "data": 1}}, mesh.shape
    # each process's epochs of a 6-epoch season, gathered to both
    shard = partition_epochs(6)
    local = np.asarray([float(e) for e in shard.indices], np.float32)
    got = all_gather_host({{"epochs": local}})["epochs"]
    assert got.shape == (2, 3), got.shape
    np.testing.assert_array_equal(got.ravel(), np.arange(6.0))

    cfg = json.loads(Path(sys.argv[2]).read_text())
    res = Path(cfg["paths"]["results_dir"]) / f"rank{{rank}}"
    cfg["paths"]["results_dir"] = str(res)
    pipe = Pipeline(cfg, device="cpu")
    eps = pipe.run_distributed()
    rows = {{}}
    for name in ("residuals_image.csv", "estimated_cameras.csv"):
        path = res / name
        rows[name] = (len(path.read_text().splitlines()) - 1
                      if path.exists() else 0)
    out = {{"rank": rank, "ids": sorted(eps._epochs),
           "status": [eps[i].quality["status"] for i in sorted(eps._epochs)],
           "features": [len(eps[i].features["cam1"])
                        for i in sorted(eps._epochs)],
           "matches": [eps[i].quality["stats"]["n_matches"]
                       for i in sorted(eps._epochs)],
           "checkpoints": len(list(res.rglob("*.pickle"))), "rows": rows}}
    print("WORKER_OK", json.dumps(out), flush=True)
""")


def _sift_season(root: Path) -> dict:
    """A 3-epoch SIFT season with tracking: the smallest frames at which
    every epoch is ok (160 x 240)."""
    cfg = StereoSeason(160, 240, 240.0).write(root, max_keypoints=1024)
    cfg["proc"].update(do_tracking=True)
    cfg["matching"] = dict(cfg["matching"], matcher="sift",
                           max_keypoints=1024,
                           options={"dual_orientation": False})
    return cfg


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    cfg = _sift_season(root)
    (root / "cfg.json").write_text(json.dumps(cfg))
    # a pid-derived port: a fixed one collides with TIME_WAIT sockets
    # when the suite runs again at once
    port = 31000 + (os.getpid() % 900)
    code = _WORKER.format(repo=str(REPO), port=port)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(i), str(root / "cfg.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=REPO)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-3000:]}"
    return [json.loads(out.split("WORKER_OK ", 1)[1].splitlines()[0])
            for out in outs]


def test_two_process_collectives(two_processes):
    """init_distributed, the global mesh and all_gather_host in each
    process (asserted there)."""
    assert [r["rank"] for r in two_processes] == [0, 1]


def test_two_process_tracked_season(two_processes):
    """Shards {0, 1} and {2}; process 1 first runs epoch 1 as the
    tracking warm seed, which it neither records nor checkpoints nor
    writes to the CSV sinks."""
    p0, p1 = two_processes
    assert p0["ids"] + p1["ids"] == [0, 1, 2]
    assert p0["status"] + p1["status"] == ["ok"] * 3
    assert p0["checkpoints"] == 2 and p1["checkpoints"] == 1
    assert p0["rows"] == {"residuals_image.csv": 2,
                          "estimated_cameras.csv": 2}
    assert p1["rows"] == {"residuals_image.csv": 1,
                          "estimated_cameras.csv": 1}
    # epoch 2 carries the warm seed's tracked features after its matches
    assert p1["features"][0] > p1["matches"][0]


def test_run_distributed_single_process_equals_run(tmp_path):
    cfg = _sift_season(tmp_path)
    cfg["proc"]["save_checkpoints"] = False
    out = {}
    for fn in ("run", "run_distributed"):
        c = copy.deepcopy(cfg)
        c["paths"]["results_dir"] = str(tmp_path / fn)
        out[fn] = list(getattr(Pipeline(c, device="cpu"), fn)())
    assert len(out["run"]) == 3
    keys = ("n_putative", "n_matches", "n_orientation_inliers")
    for a, b in zip(out["run"], out["run_distributed"]):
        assert a.quality["status"] == b.quality["status"] == "ok"
        assert [a.quality["stats"][k] for k in keys] \
            == [b.quality["stats"][k] for k in keys]
        for c in ("cam1", "cam2"):
            np.testing.assert_array_equal(
                a.features[c].track_ids_to_numpy(),
                b.features[c].track_ids_to_numpy())


# -- the staged pipeline ----------------------------------------------------

def test_split_devices_rule_equals_jax():
    import jax

    devs = jax.devices()
    for n in range(2, len(devs) + 1):
        for split in (0.1, 0.25, 0.5, 0.75, 0.9):
            a, b = split_devices(["cpu"] * n, split)
            ja, jb = jsplit(devs[:n], split)
            assert (len(a), len(b)) == (ja.devices.size, jb.devices.size)
    with pytest.raises(ValueError, match=">= 2"):
        split_devices(["cpu"])


def test_staged_pipeline_equals_sequential():
    """SuperPoint's dense descriptors as stage A, a similarity argmax as
    stage B: the outputs of sequential calls, in order, on stage B's
    device."""
    net = SuperPointNet()
    net.load_state_dict(superpoint_state_dict(load_params(
        REPO_WEIGHTS / "superpoint_synthetic.npz")))
    net.eval()

    @torch.inference_mode()
    def extract(batch):
        return {"d0": net(batch["im0"][:, None])[1],
                "d1": net(batch["im1"][:, None])[1]}

    def match(feats):
        d0 = feats["d0"].flatten(2).mT
        d1 = feats["d1"].flatten(2).mT
        return torch.bmm(d0, d1.mT).argmax(-1)

    pipe = StagedPipeline(extract, match, devices=["cpu", "cpu"])
    r = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(r.uniform(size=(4, 32, 32))
                                    .astype(np.float32))
                for k in ("im0", "im1")} for _ in range(3)]
    outs = pipe.run(batches)
    assert len(outs) == 3
    for b, o in zip(batches, outs):
        assert o.device == pipe.device_b
        assert torch.equal(o, match(extract(b)))
