"""The port's assignment solvers (``ops/lap.py``, the C++ of ``csrc/lap.cpp``
built with g++) against the JAX package's native solver
(``ops/lap.py`` over ``native/lap.cpp``): the same pairs, not only the
same cost, on rectangular costs, ties, 1e6-gated costs, +inf entries and
empty sides; the greedy matcher the same. Pairs are compared exactly.
Where the build fails the port raises: it has no SciPy fallback.
"""

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment as scipy_lsa
from torch_port_threads import thread_count

from lowlightenvironmentvideoobjectdetection_torch.ops import lap as T
from lowlightenvironmentvideoobjectdetection_tpu.ops import lap as J


_pinned_threads = thread_count(1)


def _same(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def _costs(seed, n):
    """n random costs: shapes 0-8 x 0-8, small integer values (many ties),
    a share gated at 1e6 and some +inf."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        r, c = rng.integers(0, 9, 2)
        cost = rng.integers(0, 4, (r, c)).astype(np.float64)
        cost[rng.random((r, c)) < 0.3] = 1e6
        cost[rng.random((r, c)) < 0.05] = np.inf
        yield cost


def test_the_jax_solver_is_native():
    assert J.is_native()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_jv_pairs_equal_the_jax_solver(seed):
    for cost in _costs(seed, 150):
        _same(T.linear_sum_assignment(cost), J.linear_sum_assignment(cost))


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_pairs_equal_the_jax_solver(seed):
    for cost in _costs(seed, 150):
        for thr in (0.5, 2.5, 1e5):
            _same(T.greedy_assignment(cost, thr),
                  J.greedy_assignment(cost, thr))


@pytest.mark.parametrize("shape", [(0, 0), (0, 5), (4, 0)])
def test_empty_sides(shape):
    cost = np.zeros(shape)
    _same(T.linear_sum_assignment(cost), J.linear_sum_assignment(cost))
    _same(T.greedy_assignment(cost, 1.0), J.greedy_assignment(cost, 1.0))


def test_ties_and_gates_pick_the_jax_pairs_not_scipys():
    """All-equal and gated costs: SciPy's pairs differ from the JV
    solver's (equal cost), which is why the port carries the solver."""
    cases = [np.ones((3, 3)), np.full((2, 4), 1e6),
             np.array([[0, 2, 0, 2, 0], [1, 1e6, 2, 1, 1e6]], np.float64),
             np.array([[2, 1e6, 1e6, 1], [2, 1e6, 2, 1]], np.float64)]
    differs = 0
    for cost in cases:
        got = T.linear_sum_assignment(cost)
        _same(got, J.linear_sum_assignment(cost))
        ref = scipy_lsa(cost)
        assert cost[got].sum() == cost[ref].sum()
        differs += not all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert differs > 0


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(T.host_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(T.host_build.shutil, "which", lambda name: None)
    T.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            T.linear_sum_assignment(np.ones((2, 2)))
    finally:
        T.load_library.cache_clear()
