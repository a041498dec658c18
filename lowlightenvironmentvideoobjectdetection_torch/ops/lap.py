"""Linear assignment (Jonker-Volgenant) and greedy matching for tracking,
the counterpart of the JAX package's ``ops/lap.py``.

The solver is the host C++ of ``csrc/lap.cpp`` (a copy of the JAX package's
``native/lap.cpp``), compiled with the host's ``g++`` by
``utils/host_build.py`` at first use and loaded with ``ctypes``.
Pairs, not only the cost, must be those of the JAX package: on ties and on
1e6-gated costs SciPy's solver returns other pairs of equal cost, and track
ids then differ. So where the build fails this module raises; it has no
SciPy fallback.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from ..utils import host_build

SOURCE = host_build.PKG / "csrc" / "lap.cpp"

_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built solver, loaded once per process."""
    lib = ctypes.CDLL(str(host_build.build(SOURCE)))
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
