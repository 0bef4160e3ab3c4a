"""The threaded batch EXIF scanner (counterpart of
`icepy4d_tpu/native/exif.py`).

The repository's `native/exif_scan.cpp` reads the head of each JPEG and
walks its TIFF directories for DateTimeOriginal (or DateTime) and
FocalLength, files spread over threads. It is compiled with `g++` at
first use into `icepy4d_tpu_torch/_build/` (listed in .gitignore; the
library's name carries a hash of the source and flags) and bound with
ctypes. Where it cannot be built or loaded the reason is logged and
`exif_scan_batch` reads the files one by one in Python
(`core/images.py::read_exif_tags`).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from datetime import datetime
from pathlib import Path

import numpy as np

logger = logging.getLogger("icepy4d_tpu_torch")

SOURCE = Path(__file__).resolve().parents[2] / "native" / "exif_scan.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]
EXIF_DATETIME_FMT = "%Y:%m:%d %H:%M:%S"


class _Scanner:
    """The compiled library, built and loaded once a process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self._tried = False

    def _lib_path(self) -> Path:
        text = SOURCE.read_bytes() + " ".join(FLAGS).encode()
        digest = hashlib.sha256(text).hexdigest()[:16]
        return BUILD_DIR / f"libexif_scan-{digest}.so"

    def _build(self, out: Path) -> bool:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native EXIF scanner not built (g++: %s); "
                           "reading EXIF in Python", e)
            return False
        if proc.returncode != 0:
            logger.warning("native EXIF scanner not built (g++ exit %d: "
                           "%s); reading EXIF in Python", proc.returncode,
                           proc.stderr.strip()[-500:])
            return False
        os.replace(tmp, out)
        return True

    def load(self):
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            if not SOURCE.exists():
                logger.warning("native EXIF scanner source %s missing; "
                               "reading EXIF in Python", SOURCE)
                return None
            path = self._lib_path()
            if not path.exists() and not self._build(path):
                return None
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                logger.warning("native EXIF scanner not loaded (%s); "
                               "reading EXIF in Python", e)
                return None
            lib.exif_scan_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                ctypes.c_int]
            lib.exif_scan_batch.restype = ctypes.c_int
            self._lib = lib
            return lib


_SCANNER = _Scanner()


def native_available() -> bool:
    """Whether the native scanner is built and loaded (building it on
    the first call)."""
    return _SCANNER.load() is not None


def _parse(raw: str):
    try:
        return datetime.strptime(raw.strip()[:19], EXIF_DATETIME_FMT)
    except ValueError:
        return None


def exif_scan_batch(paths: list, n_threads: int = 0) -> tuple[list,
                                                              np.ndarray]:
    """EXIF of many files at once: ([datetime or None per file], focal
    lengths in mm, NaN where absent). The native scanner when it is
    available, else the Python reader file by file."""
    paths = [str(p) for p in paths]
    n = len(paths)
    lib = _SCANNER.load()
    if lib is None:
        from icepy4d_tpu_torch.core.images import read_exif_tags

        dts, focals = [], np.full(n, np.nan)
        for i, p in enumerate(paths):
            tags = read_exif_tags(p)
            raw = tags.get("DateTimeOriginal") or tags.get("DateTime")
            dts.append(_parse(str(raw)) if raw else None)
            f = tags.get("FocalLength")
            if isinstance(f, (int, float)):
                focals[i] = float(f)
        return dts, focals

    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out_dt = ctypes.create_string_buffer(20 * n)
    out_f = (ctypes.c_double * n)()
    rc = lib.exif_scan_batch(arr, n, out_dt, out_f, int(n_threads))
    if rc != 0:
        raise RuntimeError(f"exif_scan_batch returned {rc}")
    dts = []
    for i in range(n):
        raw = out_dt.raw[20 * i: 20 * i + 19].split(b"\0")[0].decode(
            "ascii", "ignore")
        dts.append(_parse(raw) if len(raw) == 19 else None)
    return dts, np.ctypeslib.as_array(out_f).copy()
