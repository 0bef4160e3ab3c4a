"""Image loading and folder datastore.

Counterpart of `icepy4d_tpu/core/images.py`. Pixels are decoded with cv2
(to RGB, as the JAX package's PIL decode gives them); EXIF tags are
read by a small pure-Python reader of the TIFF directories of a JPEG's
APP1 segment or of a TIFF file (IFD0 and the Exif sub-IFD).
`Image.get_intrinsics_from_exif` approximates K from the focal length
and the sensor width database. `ImageDS` lists a folder in sorted order
and timestamps it with one call of the native batch EXIF scanner
(`native/exif.py`).
"""

from __future__ import annotations

import logging
import struct
from datetime import datetime
from pathlib import Path

import numpy as np

from icepy4d_tpu_torch.core.constants import DATE_FMT, DATETIME_FMT, TIME_FMT

logger = logging.getLogger("icepy4d_tpu_torch")

IMAGE_EXT = (".jpg", ".jpeg", ".png", ".tif", ".tiff", ".bmp")
EXIF_DATETIME_FMT = "%Y:%m:%d %H:%M:%S"

# the tags this reader names; others are kept under their numeric ids
EXIF_TAGS = {0x010F: "Make", 0x0110: "Model", 0x0132: "DateTime",
             0x8769: "ExifOffset", 0x9003: "DateTimeOriginal",
             0x920A: "FocalLength"}
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 9: 4, 10: 8}


def read_image(path, color: bool = True,
               resize: tuple[int, int] | None = None) -> np.ndarray:
    """Decode an image to an RGB (or grayscale) uint8 array."""
    import cv2

    im = cv2.imread(str(path),
                    cv2.IMREAD_COLOR if color else cv2.IMREAD_GRAYSCALE)
    if im is None:
        raise FileNotFoundError(f"cannot decode image {path}")
    if color:
        im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
    if resize is not None:
        im = cv2.resize(im, tuple(resize), interpolation=cv2.INTER_LINEAR)
    return im


def _parse_tiff(buf: bytes) -> dict:
    """Tags of IFD0 and the Exif sub-IFD of a TIFF structure."""
    if buf[:2] == b"II":
        end = "<"
    elif buf[:2] == b"MM":
        end = ">"
    else:
        return {}
    tags: dict = {}

    def value(typ, count, field, offset_bytes):
        size = _TYPE_SIZE.get(typ, 1) * count
        data = field if size <= 4 else buf[offset_bytes:offset_bytes + size]
        if typ == 2:
            return data[:count].split(b"\0", 1)[0].decode("latin-1")
        if typ == 3:
            return struct.unpack(f"{end}{count}H", data[:2 * count])[0]
        if typ in (4, 9):
            return struct.unpack(f"{end}{count}{'L' if typ == 4 else 'l'}",
                                 data[:4 * count])[0]
        if typ in (5, 10):
            num, den = struct.unpack(f"{end}{'LL' if typ == 5 else 'll'}",
                                     data[:8])
            return num / den if den else 0.0
        return data

    def read_ifd(offset):
        if offset <= 0 or offset + 2 > len(buf):
            return
        (n,) = struct.unpack(f"{end}H", buf[offset:offset + 2])
        for i in range(n):
            e = offset + 2 + 12 * i
            if e + 12 > len(buf):
                return
            tag, typ, count = struct.unpack(f"{end}HHL", buf[e:e + 8])
            field = buf[e + 8:e + 12]
            (ptr,) = struct.unpack(f"{end}L", field)
            try:
                tags[EXIF_TAGS.get(tag, tag)] = value(typ, count, field, ptr)
            except (struct.error, ValueError):
                continue

    (ifd0,) = struct.unpack(f"{end}L", buf[4:8])
    read_ifd(ifd0)
    sub = tags.get("ExifOffset")
    if isinstance(sub, int):
        read_ifd(sub)
    return tags


def read_exif_tags(path) -> dict:
    """EXIF tags of a JPEG or TIFF file ({} when there are none)."""
    try:
        data = Path(path).read_bytes()
    except OSError:
        return {}
    try:
        if data[:2] in (b"II", b"MM"):
            return _parse_tiff(data)
        if data[:2] != b"\xff\xd8":
            return {}
        pos = 2
        while pos + 4 <= len(data) and data[pos] == 0xFF:
            marker = data[pos + 1]
            if marker in (0xD9, 0xDA):          # end of image, scan data
                break
            (seg_len,) = struct.unpack(">H", data[pos + 2:pos + 4])
            seg = data[pos + 4:pos + 2 + seg_len]
            if marker == 0xE1 and seg[:6] == b"Exif\0\0":
                return _parse_tiff(seg[6:])
            pos += 2 + seg_len
    except (struct.error, IndexError):
        pass
    return {}


class Image:
    """Lazily decoded image with EXIF metadata. A pickled Image keeps its
    path and metadata; its pixels are decoded again on first use."""

    def __init__(self, path: str | Path):
        self._path = Path(path)
        self._value: np.ndarray | None = None
        self._exif = None
        self._datetime: datetime | None = None
        self._width = self._height = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_value"] = None
        return state

    @property
    def path(self) -> Path:
        return self._path

    @property
    def name(self) -> str:
        return self._path.name

    @property
    def stem(self) -> str:
        return self._path.stem

    @property
    def exif(self) -> dict:
        if self._exif is None:
            self._exif = read_exif_tags(self._path)
        return self._exif

    def _read_size(self) -> None:
        self._height, self._width = self.value.shape[:2]

    @property
    def width(self) -> int:
        if self._width is None:
            self._read_size()
        return self._width

    @property
    def height(self) -> int:
        if self._height is None:
            self._read_size()
        return self._height

    @property
    def datetime(self) -> datetime | None:
        """Capture time from EXIF DateTimeOriginal, else DateTime."""
        if self._datetime is None:
            raw = self.exif.get("DateTimeOriginal") or self.exif.get(
                "DateTime")
            if raw:
                try:
                    self._datetime = datetime.strptime(str(raw).strip(),
                                                       EXIF_DATETIME_FMT)
                except ValueError:
                    self._datetime = None
        return self._datetime

    @property
    def date(self) -> str | None:
        dt = self.datetime
        return dt.strftime(DATE_FMT) if dt else None

    @property
    def time(self) -> str | None:
        dt = self.datetime
        return dt.strftime(TIME_FMT) if dt else None

    @property
    def timestamp(self) -> str | None:
        dt = self.datetime
        return dt.strftime(DATETIME_FMT) if dt else None

    @property
    def value(self) -> np.ndarray:
        if self._value is None:
            self._value = read_image(self._path)
        return self._value

    def read_image(self) -> np.ndarray:
        self._value = read_image(self._path)
        return self._value

    def reset_value(self) -> None:
        self._value = None

    def extract_patch(self, limits: tuple[int, int, int, int]) -> np.ndarray:
        """Crop [xmin, ymin, xmax, ymax]."""
        x0, y0, x1, y1 = (int(v) for v in limits)
        return self.value[y0:y1, x0:x1]

    def get_intrinsics_from_exif(self) -> np.ndarray | None:
        """Approximate K from the EXIF focal length and the sensor width
        of the EXIF make and model: f_px = f_mm * width / sensor_mm,
        principal point at the centre. None when a tag is missing or
        the camera is not in the database."""
        from icepy4d_tpu_torch.core.sensor_width_database import \
            SensorWidthDatabase

        ex = self.exif
        focal = ex.get("FocalLength")
        make, model = ex.get("Make"), ex.get("Model")
        if focal is None or make is None or model is None:
            return None
        try:
            sensor_w = SensorWidthDatabase().lookup(str(make), str(model))
        except LookupError:
            return None
        f_px = float(focal) * self.width / sensor_w
        return np.array([[f_px, 0, self.width / 2.0],
                         [0, f_px, self.height / 2.0],
                         [0, 0, 1]], np.float32)


class ImageDS:
    """Sorted folder datastore of images."""

    def __init__(self, folder: str | Path, ext: str | None = None):
        self.folder = Path(folder)
        if not self.folder.is_dir():
            raise FileNotFoundError(f"Image folder {folder} not found")
        exts = (f".{ext.lstrip('.')}".lower(),) if ext else IMAGE_EXT
        self.files = sorted(p for p in self.folder.iterdir()
                            if p.suffix.lower() in exts)
        self._images = [Image(p) for p in self.files]
        self._prescan_exif()

    def _prescan_exif(self) -> None:
        """Timestamp the whole folder with one call of the native batch
        scanner; where it is not available (its loader logs why) each
        image reads its own EXIF when first asked."""
        from icepy4d_tpu_torch.native import (exif_scan_batch,
                                              native_available)

        if not self.files or not native_available():
            return
        dts, _ = exif_scan_batch(self.files)
        for im, dt in zip(self._images, dts):
            if dt is not None:
                im._datetime = dt

    def __len__(self) -> int:
        return len(self._images)

    def __getitem__(self, idx: int) -> Image:
        return self._images[idx]

    def __iter__(self):
        return iter(self._images)

    def read_image(self, idx: int) -> Image:
        return self._images[idx]

    def get_image_path(self, idx: int) -> Path:
        return self.files[idx]

    def get_image_stem(self, idx: int) -> str:
        return self.files[idx].stem

    def timestamps(self) -> list[datetime | None]:
        return [im.datetime for im in self._images]

    def write_exif_to_csv(self, path) -> None:
        import csv

        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["name", "date", "time"])
            for im in self._images:
                w.writerow([im.name, im.date, im.time])
