"""The port's exchange formats (`io/colmap.py`, `export2colmap.py`,
`export2bundler.py`, `export2calge.py`) == icepy4d_tpu's on one seeded
two-camera solution.

COLMAP binary and text models, the text model of an epoch, Bundler
.out files, image lists, ODM GCP files and both CALGE files are byte-equal
between the two packages' writers; each package reads back what the
other wrote to equal models; the COLMAP databases hold equal rows; the
qvec helpers and pair ids agree; the hloc h5 files hold equal datasets.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import icepy4d_tpu.io as JIO
from icepy4d_tpu.core import Camera as JCamera
from icepy4d_tpu.core import Features as JFeatures
from icepy4d_tpu.core import Points as JPoints
from icepy4d_tpu.core import Targets as JTargets
from icepy4d_tpu.io import colmap as JC
import icepy4d_tpu_torch.io as PIO
from icepy4d_tpu_torch.core import Camera, Features, Points, Targets
from icepy4d_tpu_torch.io import colmap as PC
from torch_port_inputs import rotation_zyx


def solution(cls_cam, cls_feat, cls_pts, seed=0, n=40):
    """Two 640x480 cameras, n tracked features in each, n points."""
    rng = np.random.default_rng(seed)
    K = np.array([[600.0, 0, 320.5], [0, 598.0, 240.25], [0, 0, 1]])
    dist = np.array([-0.1, 0.02, 0.001, -0.0005])
    cams, feats = {}, {}
    for i, name in enumerate(("cam1", "cam2")):
        E = np.eye(4)
        E[:3, :3] = rotation_zyx(0.05 * i, 0.02, -0.01 * i)
        E[:3, 3] = [-3.0 * i, 0.1, 0.2]
        cams[name] = cls_cam.create(width=640, height=480, K=K, dist=dist,
                                    extrinsics=E)
        feats[name] = cls_feat.from_numpy(
            rng.uniform([0, 0], [640, 480], (n, 2)),
            descr=rng.uniform(0, 1, (n, 8)), scores=rng.uniform(0, 1, n),
            track_ids=np.arange(n) + 5)
    pts = cls_pts()
    pts.append_points_from_numpy(
        rng.uniform([-5, -5, 20], [5, 5, 30], (n, 3)),
        track_ids=np.arange(n) + 5,
        colors=rng.integers(0, 256, (n, 3)).astype(np.float32))
    images = {c: SimpleNamespace(name=f"IMG_{i}.jpg",
                                 path=f"/data/{c}/IMG_{i}.jpg")
              for i, c in enumerate(cams)}
    return images, cams, feats, pts


@pytest.fixture
def both():
    return (solution(JCamera, JFeatures, JPoints),
            solution(Camera, Features, Points))


def same_files(a, b, names):
    for n in names:
        assert (b / n).read_bytes() == (a / n).read_bytes(), n


def test_colmap_models(tmp_path, both):
    (ji, jc, jf, jp), (pi, pc, pf, pp) = both
    JIO.export_solution_to_colmap_binary(tmp_path / "jb", ji, jc, jp)
    PIO.export_solution_to_colmap_binary(tmp_path / "pb", pi, pc, pp)
    same_files(tmp_path / "jb", tmp_path / "pb",
               ("cameras.bin", "images.bin", "points3D.bin"))
    JIO.export_solution_to_colmap(tmp_path / "jt", ji, jc, points=jp)
    PIO.export_solution_to_colmap(tmp_path / "pt", pi, pc, points=pp)
    same_files(tmp_path / "jt", tmp_path / "pt",
               ("cameras.txt", "images.txt", "points3D.txt"))
    # each reads the other's binary model to the same objects
    a = JC.read_model(tmp_path / "pb")
    b = PC.read_model(tmp_path / "jb")
    for da, db in zip(a, b):
        assert da.keys() == db.keys()
        for k in da:
            for f, v in vars(da[k]).items():
                np.testing.assert_array_equal(getattr(db[k], f), v)
    # text round trip with tracks and 2-D observations
    cams, imgs, pts3 = b
    imgs[1].xys = np.array([[1.5, 2.25], [3.0, 4.0]])
    imgs[1].point3D_ids = np.array([5, -1])
    pts3[5].image_ids = np.array([1], np.int32)
    pts3[5].point2D_idxs = np.array([0], np.int32)
    PC.write_model(cams, imgs, pts3, tmp_path / "pm", ext=".txt")
    JC.write_model(cams, imgs, pts3, tmp_path / "jm", ext=".txt")
    same_files(tmp_path / "jm", tmp_path / "pm",
               ("cameras.txt", "images.txt", "points3D.txt"))
    back = PC.read_model(tmp_path / "pm")
    np.testing.assert_array_equal(back[1][1].xys, imgs[1].xys)
    assert back[2][5].image_ids.tolist() == [1]
    with pytest.raises(ValueError, match="extension"):
        PC.write_model(cams, imgs, pts3, tmp_path / "x", ext=".json")


def test_qvec_and_pair_ids():
    rng = np.random.default_rng(1)
    for _ in range(20):
        R = rotation_zyx(*rng.uniform(-3, 3, 3)).astype(np.float64)
        q = PC.rotmat2qvec(R)
        np.testing.assert_array_equal(q, JC.rotmat2qvec(R))
        np.testing.assert_array_equal(PC.qvec2rotmat(q), JC.qvec2rotmat(q))
        np.testing.assert_allclose(PC.qvec2rotmat(q), R, atol=1e-6)
    for a, b in ((1, 2), (7, 3), (2 ** 30, 5)):
        pid = PC.image_ids_to_pair_id(a, b)
        assert pid == JC.image_ids_to_pair_id(a, b)
        assert PC.pair_id_to_image_ids(pid) == JC.pair_id_to_image_ids(pid)


def test_colmap_database(tmp_path, both):
    (ji, jc, jf, _), (pi, pc, pf, _) = both
    m = {("cam1", "cam2"): np.stack([np.arange(30), np.arange(30)[::-1]],
                                    -1)}
    JIO.export_to_colmap_database(tmp_path / "j.db", ji, jc, jf, m)
    PIO.export_to_colmap_database(tmp_path / "p.db", pi, pc, pf, m)
    dj = JC.COLMAPDatabase.connect(tmp_path / "j.db")
    dp = PC.COLMAPDatabase.connect(tmp_path / "p.db")
    try:
        for table in ("cameras", "images", "keypoints", "descriptors",
                      "matches", "two_view_geometries"):
            q = f"SELECT * FROM {table} ORDER BY 1"
            assert dp.execute(q).fetchall() == dj.execute(q).fetchall()
        np.testing.assert_array_equal(dp.read_matches(2, 1),
                                      dj.read_matches(2, 1))
        np.testing.assert_array_equal(dp.read_keypoints(1)[:, :2],
                                      pf["cam1"].kpts_to_numpy())
        assert len(dp.read_matches(1, 3)) == 0
    finally:
        dj.close()
        dp.close()


def test_bundler_calge_odm(tmp_path, both):
    (ji, jc, jf, jp), (pi, pc, pf, pp) = both
    JIO.write_bundler_out(tmp_path / "j", "sol", ji, jc, jf, jp)
    PIO.write_bundler_out(tmp_path / "p", "sol", pi, pc, pf, pp)
    same_files(tmp_path / "j", tmp_path / "p", ("sol.out", "im_list.txt"))
    cj, xj, oj = JIO.read_bundler_out(tmp_path / "p" / "sol.out")
    cp, xp, op = PIO.read_bundler_out(tmp_path / "p" / "sol.out")
    np.testing.assert_array_equal(xp, xj)
    assert op == oj and len(cp) == 2
    for a, b in zip(cj, cp):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    np.testing.assert_allclose(xp, pp.to_numpy(), atol=1e-4)

    for mod, feats, imgs, pts, tag in ((JIO, jf, ji, jp, "j"),
                                       (PIO, pf, pi, pp, "p")):
        mod.export_keypoints_for_calge(tmp_path / f"{tag}_kp.txt", feats,
                                       imgs)
        mod.export_keypoints_for_calge(tmp_path / f"{tag}_xe.txt", feats,
                                       imgs, image_size=(480, 640),
                                       pixel_size_micron=3.76)
        mod.export_points3D_for_calge(tmp_path / f"{tag}_p3.txt", pts)
    for n in ("kp.txt", "xe.txt", "p3.txt"):
        assert (tmp_path / f"p_{n}").read_bytes() == \
            (tmp_path / f"j_{n}").read_bytes()
    with pytest.raises(ValueError, match="image_size"):
        PIO.export_keypoints_for_calge(tmp_path / "x.txt", pf, pi,
                                       pixel_size_micron=3.76)

    (tmp_path / "t").mkdir()
    (tmp_path / "t" / "world.csv").write_text(
        "label,X,Y,Z\nT1,1.5,2.5,20.25\nT2,-1.0,0.5,25.0\nT3,0,0,22\n")
    for i in range(2):
        (tmp_path / "t" / f"c{i}.csv").write_text(
            f"label,x,y\nT1,{100.5 + i},200.25\nT3,300,{150.75 - i}\n")
    files = [tmp_path / "t" / f"c{i}.csv" for i in range(2)]
    tj = JTargets(files, tmp_path / "t" / "world.csv")
    tp = Targets(files, tmp_path / "t" / "world.csv")
    JIO.write_odm_gcps(tmp_path / "j", tj, ji, ["T1", "T2", "T3"])
    PIO.write_odm_gcps(tmp_path / "p", tp, pi, ["T1", "T2", "T3"])
    same_files(tmp_path / "j", tmp_path / "p", ("gcps.txt",))


def test_features_to_h5(tmp_path, both):
    import h5py

    (ji, _, jf, _), (pi, _, pf, _) = both
    paths = (JIO.features_to_h5(tmp_path / "j", ji, jf),
             PIO.features_to_h5(tmp_path / "p", pi, pf))
    for fj, fp in zip(*paths):
        with h5py.File(fj) as a, h5py.File(fp) as b:
            names = []
            a.visit(names.append)
            other = []
            b.visit(other.append)
            assert names == other
            for n in names:
                if isinstance(a[n], h5py.Dataset):
                    np.testing.assert_array_equal(b[n][()], a[n][()])
