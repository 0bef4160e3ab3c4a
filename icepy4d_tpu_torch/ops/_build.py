"""Build and bind the hand-written CUDA kernels in `csrc/`.

Each source is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface, at first use, into `_build/` (listed
in .gitignore), and loaded with ctypes. A library's file name carries a
hash of its source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. `build_all` starts one `nvcc` per
source at once. `SOURCE_FLAGS` adds flags for one source.

Every C entry takes its pointers and PyTorch's current stream as
`void*`, launches without synchronising, and returns
`cudaGetLastError()`; `CudaKernel.launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCE_FLAGS = {
    # the sweep's costs must round as its plain version's do: no a * b + c
    # may be contracted into an FMA
    "sweep.cu": ["-fmad=false"],
    # the attention and dual-softmax entries look libcuda's
    # cuTensorMapEncodeTiled up with dlopen/dlsym (no link against libcuda)
    "attention.cu": ["-ldl"],
    "dual_softmax.cu": ["-ldl"],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _flags(source: str) -> list[str]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, [])


def _lib_path(source: str) -> Path:
    text = (CSRC / source).read_bytes() + " ".join(_flags(source)).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all(sources) -> None:
    """Compile every source whose library is missing, all at once."""
    with _lock:
        todo = [s for s in sources if not _lib_path(s).exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            out = _lib_path(src)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *_flags(src), "-o", str(tmp), str(CSRC / src)]
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_logs[src] = log
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if need be."""
    with _lock:
        lib = _libs.get(source)
    if lib is not None:
        return lib
    build_all([source])
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(str(_lib_path(source)))
        return _libs[source]


class CudaKernel:
    """One C entry of a kernel library, with its launch count.

    `args` lists the ctypes type of each argument before the stream;
    the stream is appended as the last argument of every launch.
    """

    def __init__(self, source: str, symbol: str, args: list):
        self.source = source
        self.symbol = symbol
        self._args = list(args)
        self._fn = None
        self.launches = 0

    def _entry(self):
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self._args + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self._entry()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed: CUDA error {err}")
        self.launches += 1
