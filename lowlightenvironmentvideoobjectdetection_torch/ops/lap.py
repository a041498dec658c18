"""Linear assignment (Jonker-Volgenant) and greedy matching for tracking,
the counterpart of the JAX package's ``ops/lap.py``.

The solver is the host C++ of ``csrc/lap.cpp`` (a copy of the JAX package's
``native/lap.cpp``), compiled with the host's ``g++`` into ``_build/`` at
first use (named by a hash of the source and flags, like the CUDA library
of ``cuda_build.py``, which does not build it; no ``-march=native``, so a
library built on one host loads on another) and loaded with ``ctypes``.
Pairs, not only the cost, must be those of the JAX package: on ties and on
1e6-gated costs SciPy's solver returns other pairs of equal cost, and track
ids then differ. So where the build fails this module raises; it has no
SciPy fallback.
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
from typing import Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "lap.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"liblap_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/lap.cpp`` unless a library for its hash exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the JV solver (csrc/lap.cpp) is "
                           "built with the host's g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        lib = os.path.join(tmpdir, out.name)
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", lib],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent loader sees all or none
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built solver, loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    lib.lap_solve.restype = ctypes.c_double
    lib.lap_solve.argtypes = [_DP, ctypes.c_int32, ctypes.c_int32, _IP, _IP]
    lib.greedy_solve.restype = ctypes.c_int32
    lib.greedy_solve.argtypes = [_DP, ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_double, _IP, _IP]
    return lib


def _pairs(solve, cost: np.ndarray, *args) -> Tuple[np.ndarray, np.ndarray]:
    cost = np.ascontiguousarray(cost, np.float64)
    if cost.ndim != 2:
        raise ValueError(f"cost must be 2-d, got shape {cost.shape}")
    n_rows, n_cols = cost.shape
    if n_rows == 0 or n_cols == 0:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    r2c = np.full((n_rows,), -1, np.int32)
    c2r = np.full((n_cols,), -1, np.int32)
    solve(cost.ctypes.data_as(_DP), n_rows, n_cols, *args,
          r2c.ctypes.data_as(_IP), c2r.ctypes.data_as(_IP))
    rows = np.nonzero(r2c >= 0)[0]
    return rows.astype(np.int64), r2c[rows].astype(np.int64)


def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """SciPy's API: (row_ind, col_ind) of the min-cost assignment over the
    rectangular ``cost``; +inf entries are never assigned."""
    return _pairs(load_library().lap_solve, cost)


def greedy_assignment(cost: np.ndarray, thr: float
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy global-minimum matching of pairs below ``thr`` (the SORT IoU
    fallback). Returns (row_ind, col_ind)."""
    return _pairs(load_library().greedy_solve, cost, float(thr))
