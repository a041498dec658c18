"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source,
all started together, and linked into one shared library with a plain C
interface, at first use, and loaded with ``ctypes``. The
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
SOURCES = ("deform_conv.cu", "roi_align.cu", "selsa_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    # x, offset, mask, cols, N, C, H, W, G, dtype, stream
    "llvod_dcn_im2col": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # grad_cols, offset, mask, grad_x (f32), N, C, H, W, G, stream
    "llvod_dcn_col2im": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # grad_cols, x, offset, mask, grad_offset, grad_mask, N, C, H, W, G,
    # dtype, stream
    "llvod_dcn_col2im_coord": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P),
    # feat, rois, binds, out, B, H, W, C, N, spatial_scale, offset,
    # out_size, sampling_ratio, dtype, stream
    "llvod_roi_align": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                        _I, _P),
    # grad_out, rois, binds, grad (f32), B, H, W, C, N, spatial_scale,
    # offset, out_size, sampling_ratio, dtype, stream
    "llvod_roi_align_backward": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                                 _I, _I, _I, _P),
    # q, k1, v1, k2, v2, b1, b2, out, S, N, NB, M1, M2, q_dtype, kv_dtype,
    # body, stream
    "llvod_selsa_attention_2slab": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, b, out, S, N, NB, M, q_dtype, kv_dtype, body, stream
    "llvod_selsa_attention_1slab": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _P),
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


def _run(procs) -> None:
    """Wait for every nvcc process; raise with the first one's errors."""
    failed = []
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> Path:
    """Compile the sources unless a library for their hash exists: one nvcc
    per source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [str(Path(tmpdir) / (Path(s).stem + ".o")) for s in SOURCES]
        _run([(s, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)],
            stderr=subprocess.PIPE, text=True))
            for s, o in zip(SOURCES, objs)])
        lib = str(Path(tmpdir) / out.name)
        _run([("link", subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
            stderr=subprocess.PIPE, text=True))])
        os.replace(lib, out)  # atomic: a concurrent loader sees all or none
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
