"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, at first use, and loaded with ``ctypes``. The
library's name carries a hash of the sources and flags, so a changed source is
rebuilt and a stale library is never loaded. The build directory
(``_build/`` beside this package's ``csrc/``) is listed in ``.gitignore``.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("roi_align.cu", "selsa_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # feat, rois, binds, out, B, H, W, C, N, spatial_scale, offset,
    # out_size, sampling_ratio, dtype, stream
    "llvod_roi_align": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                        _I, _P),
    # q, k1, v1, k2, v2, b1, b2, out, N, NB, M1, M2, q_dtype, kv_dtype, stream
    "llvod_selsa_attention_2slab": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, (home, "/usr/local/cuda")):
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libllvod_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for their hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
