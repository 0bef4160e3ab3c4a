"""COLMAP binary / text models and the COLMAP project database
(counterpart of `icepy4d_tpu/io/colmap.py`; host numpy and sqlite3).

The formats follow the public COLMAP specification
(colmap/src/colmap/scene/reconstruction_io.cc, database.cc): binary
sections of fixed stride parse with one `frombuffer`, variable-length
records with a single-pass cursor; the SQLite database uses the
standard schema, so COLMAP's tools and hloc read the keypoints and
matches written here.
"""

from __future__ import annotations

import sqlite3
import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

# public COLMAP camera model ids -> (name, n_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray          # (4,) w x y z
    tvec: np.ndarray          # (3,)
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(
        default_factory=lambda: np.full((0,), -1, np.int64))

    def qvec2rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R) -> np.ndarray:
    R = np.asarray(R, np.float64)
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1],
         R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0]) if q[0] != 0 else q


# -- binary model -------------------------------------------------------------


def write_cameras_binary(cameras: dict, path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid,
                                cam.width, cam.height))
            f.write(np.asarray(cam.params, "<f8").tobytes())


def read_cameras_binary(path) -> dict:
    buf = Path(path).read_bytes()
    n = struct.unpack_from("<Q", buf, 0)[0]
    off = 8
    cams = {}
    for _ in range(n):
        cid, mid, w, h = struct.unpack_from("<iiQQ", buf, off)
        off += 24
        name, np_ = CAMERA_MODELS[mid]
        params = np.frombuffer(buf, "<f8", np_, off).copy()
        off += 8 * np_
        cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def write_images_binary(images: dict, path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, "<f8").tobytes())
            f.write(np.asarray(im.tvec, "<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            n = len(im.xys)
            f.write(struct.pack("<Q", n))
            # point3D_id is int64 inside a mixed record; a structured
            # array gives the exact interleaved layout in one write
            s = np.zeros(n, dtype=[("x", "<f8"), ("y", "<f8"),
                                   ("pid", "<i8")])
            s["x"] = im.xys[:, 0] if n else []
            s["y"] = im.xys[:, 1] if n else []
            s["pid"] = im.point3D_ids if n else []
            f.write(s.tobytes())


def read_images_binary(path) -> dict:
    buf = Path(path).read_bytes()
    n = struct.unpack_from("<Q", buf, 0)[0]
    off = 8
    images = {}
    rec_t = np.dtype([("x", "<f8"), ("y", "<f8"), ("pid", "<i8")])
    for _ in range(n):
        iid = struct.unpack_from("<i", buf, off)[0]
        off += 4
        qvec = np.frombuffer(buf, "<f8", 4, off).copy()
        off += 32
        tvec = np.frombuffer(buf, "<f8", 3, off).copy()
        off += 24
        cam_id = struct.unpack_from("<i", buf, off)[0]
        off += 4
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode()
        off = end + 1
        npts = struct.unpack_from("<Q", buf, off)[0]
        off += 8
        rec = np.frombuffer(buf, rec_t, npts, off)
        off += rec_t.itemsize * npts
        images[iid] = ColmapImage(
            iid, qvec, tvec, cam_id, name,
            np.stack([rec["x"], rec["y"]], -1) if npts
            else np.zeros((0, 2)),
            rec["pid"].copy())
    return images


def write_points3D_binary(points3D: dict, path) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points3D)))
        for pt in points3D.values():
            f.write(struct.pack("<Q", pt.id))
            f.write(np.asarray(pt.xyz, "<f8").tobytes())
            f.write(np.asarray(pt.rgb, np.uint8).tobytes())
            f.write(struct.pack("<d", float(pt.error)))
            n = len(pt.image_ids)
            f.write(struct.pack("<Q", n))
            s = np.zeros(n, dtype=[("im", "<i4"), ("p2d", "<i4")])
            s["im"] = pt.image_ids
            s["p2d"] = pt.point2D_idxs
            f.write(s.tobytes())


def read_points3D_binary(path) -> dict:
    buf = Path(path).read_bytes()
    n = struct.unpack_from("<Q", buf, 0)[0]
    off = 8
    pts = {}
    tr_t = np.dtype([("im", "<i4"), ("p2d", "<i4")])
    for _ in range(n):
        pid = struct.unpack_from("<Q", buf, off)[0]
        off += 8
        xyz = np.frombuffer(buf, "<f8", 3, off).copy()
        off += 24
        rgb = np.frombuffer(buf, np.uint8, 3, off).copy()
        off += 3
        err = struct.unpack_from("<d", buf, off)[0]
        off += 8
        tn = struct.unpack_from("<Q", buf, off)[0]
        off += 8
        tr = np.frombuffer(buf, tr_t, tn, off)
        off += tr_t.itemsize * tn
        pts[pid] = ColmapPoint3D(pid, xyz, rgb, float(err),
                                 tr["im"].copy(), tr["p2d"].copy())
    return pts


def write_model(cameras: dict, images: dict, points3D: dict, path,
                ext: str = ".bin") -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if ext == ".bin":
        write_cameras_binary(cameras, path / "cameras.bin")
        write_images_binary(images, path / "images.bin")
        write_points3D_binary(points3D, path / "points3D.bin")
    elif ext == ".txt":
        _write_model_text(cameras, images, points3D, path)
    else:
        raise ValueError(f"unknown model extension {ext}")


def read_model(path, ext: str | None = None):
    path = Path(path)
    if ext is None:
        ext = ".bin" if (path / "cameras.bin").exists() else ".txt"
    if ext == ".bin":
        return (read_cameras_binary(path / "cameras.bin"),
                read_images_binary(path / "images.bin"),
                read_points3D_binary(path / "points3D.bin"))
    return _read_model_text(path)


def _write_model_text(cameras, images, points3D, path: Path) -> None:
    with open(path / "cameras.txt", "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for c in cameras.values():
            p = " ".join(f"{v:.17g}" for v in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {p}\n")
    with open(path / "images.txt", "w") as f:
        f.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ "
                "CAMERA_ID NAME / POINTS2D[] as (X Y POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(f"{v:.17g}" for v in im.qvec)
            t = " ".join(f"{v:.17g}" for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            f.write(" ".join(
                f"{x:.17g} {y:.17g} {pid}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)) + "\n")
    with open(path / "points3D.txt", "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR "
                "TRACK[] as (IMAGE_ID POINT2D_IDX)\n")
        for pt in points3D.values():
            xyz = " ".join(f"{v:.17g}" for v in pt.xyz)
            rgb = " ".join(str(int(v)) for v in pt.rgb)
            tr = " ".join(f"{i} {j}" for i, j in
                          zip(pt.image_ids, pt.point2D_idxs))
            f.write(f"{pt.id} {xyz} {rgb} {pt.error:.17g} {tr}\n")


def _read_model_text(path: Path):
    cameras = {}
    for line in open(path / "cameras.txt"):
        if line.startswith("#") or not line.strip():
            continue
        tok = line.split()
        cameras[int(tok[0])] = ColmapCamera(
            int(tok[0]), tok[1], int(tok[2]), int(tok[3]),
            np.asarray([float(v) for v in tok[4:]]))
    images = {}
    # an image with zero points still writes its (empty) second line;
    # pair lines positionally, keeping blanks
    lines = [l.rstrip("\n") for l in open(path / "images.txt")
             if not l.startswith("#")]
    for k in range(0, len(lines), 2):
        tok = lines[k].split()
        pts = lines[k + 1].split() if k + 1 < len(lines) else []
        xys = np.asarray([[float(pts[i]), float(pts[i + 1])]
                          for i in range(0, len(pts), 3)]) \
            if pts else np.zeros((0, 2))
        pids = np.asarray([int(pts[i + 2])
                           for i in range(0, len(pts), 3)], np.int64) \
            if pts else np.full((0,), -1, np.int64)
        images[int(tok[0])] = ColmapImage(
            int(tok[0]), np.asarray([float(v) for v in tok[1:5]]),
            np.asarray([float(v) for v in tok[5:8]]), int(tok[8]),
            tok[9], xys, pids)
    points3D = {}
    for line in open(path / "points3D.txt"):
        if line.startswith("#") or not line.strip():
            continue
        tok = line.split()
        tr = tok[8:]
        points3D[int(tok[0])] = ColmapPoint3D(
            int(tok[0]), np.asarray([float(v) for v in tok[1:4]]),
            np.asarray([int(v) for v in tok[4:7]], np.uint8),
            float(tok[7]),
            np.asarray([int(tr[i]) for i in range(0, len(tr), 2)],
                       np.int32),
            np.asarray([int(tr[i + 1]) for i in range(0, len(tr), 2)],
                       np.int32))
    return cameras, images, points3D


# -- project database ---------------------------------------------------------

MAX_IMAGE_ID = 2 ** 31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL,
    height INTEGER NOT NULL, params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < {maxid}),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
""".format(maxid=MAX_IMAGE_ID)


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int) -> tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    return (pair_id - image_id2) // MAX_IMAGE_ID, image_id2


def _blob(a) -> bytes:
    return np.ascontiguousarray(a).tobytes()


class COLMAPDatabase(sqlite3.Connection):
    """COLMAP-schema SQLite database (public schema, database.cc)."""

    @staticmethod
    def connect(path) -> "COLMAPDatabase":
        return sqlite3.connect(str(path), factory=COLMAPDatabase)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.executescript(_SCHEMA)

    def add_camera(self, model, width, height, params,
                   prior_focal_length=False, camera_id=None) -> int:
        if isinstance(model, str):
            model = CAMERA_MODEL_IDS[model]
        cur = self.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model, int(width), int(height),
             _blob(np.asarray(params, np.float64)),
             int(prior_focal_length)))
        return cur.lastrowid

    def add_image(self, name, camera_id, prior_q=(1, 0, 0, 0),
                  prior_t=(0, 0, 0), image_id=None) -> int:
        cur = self.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, str(name), int(camera_id), *map(float, prior_q),
             *map(float, prior_t)))
        return cur.lastrowid

    def add_keypoints(self, image_id, keypoints) -> None:
        keypoints = np.asarray(keypoints, np.float32)
        if keypoints.shape[1] == 2:  # pad to COLMAP's (x, y, scale, ori)
            keypoints = np.concatenate(
                [keypoints, np.zeros_like(keypoints)], 1)
        self.execute("INSERT INTO keypoints VALUES (?, ?, ?, ?)",
                     (image_id, *keypoints.shape, _blob(keypoints)))

    def add_descriptors(self, image_id, descriptors) -> None:
        descriptors = np.ascontiguousarray(descriptors, np.uint8)
        self.execute("INSERT INTO descriptors VALUES (?, ?, ?, ?)",
                     (image_id, *descriptors.shape, _blob(descriptors)))

    def add_matches(self, image_id1, image_id2, matches) -> None:
        matches = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        self.execute("INSERT INTO matches VALUES (?, ?, ?, ?)",
                     (image_ids_to_pair_id(image_id1, image_id2),
                      *matches.shape, _blob(matches)))

    def add_two_view_geometry(self, image_id1, image_id2, matches,
                              F=None, E=None, H=None, config=2) -> None:
        matches = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        eye = np.eye(3)
        self.execute(
            "INSERT INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_ids_to_pair_id(image_id1, image_id2),
             *matches.shape, _blob(matches), int(config),
             _blob(np.asarray(F if F is not None else eye, np.float64)),
             _blob(np.asarray(E if E is not None else eye, np.float64)),
             _blob(np.asarray(H if H is not None else eye, np.float64)),
             _blob(np.asarray([1, 0, 0, 0], np.float64)),
             _blob(np.zeros(3, np.float64))))

    # -- readers (round-trip/testing) ------------------------------------

    def read_keypoints(self, image_id) -> np.ndarray:
        r, c, data = self.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,)).fetchone()
        return np.frombuffer(data, np.float32).reshape(r, c)

    def read_matches(self, image_id1, image_id2) -> np.ndarray:
        pid = image_ids_to_pair_id(image_id1, image_id2)
        row = self.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?",
            (pid,)).fetchone()
        if row is None:
            return np.zeros((0, 2), np.uint32)
        r, c, data = row
        m = np.frombuffer(data, np.uint32).reshape(r, c)
        return m[:, ::-1] if image_id1 > image_id2 else m
