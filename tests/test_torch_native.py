"""The port's binding of the C++ host runtime (``utils/native.py``) against
the JAX package's binding and NumPy: ``bin_positions``, ``count_sort`` and
``gather_rows`` bit-identical, the library built from ``native/`` into
``build/native/`` under a hash of the source and the flags, and the
port's oracle the same with ``native_ok`` on and off."""

import numpy as np
import pytest

from mpi_grid_redistribute_tpu import domain as jdomain
from mpi_grid_redistribute_tpu.utils import native as jnative
from mpi_grid_redistribute_tpu_torch import domain as tdomain
from mpi_grid_redistribute_tpu_torch import oracle
from mpi_grid_redistribute_tpu_torch.utils import native

pytestmark = pytest.mark.skipif(
    not native.build(), reason="native library not built (no g++?)")


DOMS = [
    (dict(lo=0.0, hi=1.0, periodic=True), (4, 4, 4)),
    (dict(lo=(-1.0, 0.0, 2.5), hi=(1.0, 0.3, 7.1),
          periodic=(True, False, True)), (3, 5, 2)),
    (dict(lo=0.0, hi=1.0, ndim=2, periodic=False), (8, 8)),
]


def test_library_lives_in_build_native():
    path = native.lib_path()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert path.exists() and native.available()
    assert native.SOURCE.name == "grid_redistribute_native.cpp"


@pytest.mark.parametrize("dom_kw,gshape", DOMS)
def test_bin_bit_identical(dom_kw, gshape, rng):
    tdom, jdom = tdomain.Domain(**dom_kw), jdomain.Domain(**dom_kw)
    pos = (rng.standard_normal((100000, tdom.ndim)) * 2).astype(np.float32)
    pos[:10] = 0.0
    pos[10:20] = 1.0
    pos[20:30] = -1e-8
    want = oracle.rank_of_position(pos, tdom, tdomain.ProcessGrid(gshape))
    got = native.bin_positions(pos, tdom, tdomain.ProcessGrid(gshape))
    np.testing.assert_array_equal(want, got)
    # the reference's binding (its library where built, else its NumPy)
    np.testing.assert_array_equal(
        got, jnative.bin_positions(pos, jdom, jdomain.ProcessGrid(gshape)))


def test_count_sort_matches_stable_argsort(rng):
    dest = rng.integers(0, 9, size=50000).astype(np.int32)  # 8 + sentinel
    counts, order = native.count_sort(dest, 8)
    np.testing.assert_array_equal(counts, np.bincount(dest, minlength=9)[:8])
    np.testing.assert_array_equal(order, np.argsort(dest, kind="stable"))
    for g, w in zip((counts, order), jnative.count_sort(dest, 8)):
        np.testing.assert_array_equal(g, w)


def test_gather_rows(rng):
    src = rng.random((1000, 5)).astype(np.float32)
    order = rng.permutation(1000).astype(np.int64)[:300]
    np.testing.assert_array_equal(native.gather_rows(src, order), src[order])
    ids = rng.integers(0, 1 << 40, size=1000)  # int64 rows
    np.testing.assert_array_equal(native.gather_rows(ids, order), ids[order])
    np.testing.assert_array_equal(native.gather_rows(ids, order),
                                  jnative.gather_rows(ids, order))


@pytest.mark.parametrize("edge_kind", [None, "assignment"])
def test_oracle_native_equals_numpy(edge_kind, rng):
    """The port's padded oracle is bit-identical with ``native_ok`` on and
    off (uniform cells, and the uniform fine lattice of an assignment)."""
    dom = tdomain.Domain(0.0, 1.0, periodic=True)
    grid = tdomain.ProcessGrid((2, 2, 2))
    edges = None
    if edge_kind == "assignment":
        axes = tuple(tuple(np.linspace(0.0, 1.0, 5).tolist())
                     for _ in range(3))
        edges = tdomain.GridEdges(
            axes, assignment=tuple(int(x) for x in rng.integers(0, 8, 64)))
    n = 256
    pos = rng.random((8 * n, 3), dtype=np.float32)
    vel = rng.standard_normal((8 * n, 3)).astype(np.float32)
    counts = rng.integers(n // 2, n + 1, 8)
    outs = [oracle.redistribute_oracle_padded(
        dom, grid, pos, counts, [vel], 48, 2 * n, native_ok=ok, edges=edges)
        for ok in (True, False)]
    a, b = outs
    assert a[0].tobytes() == b[0].tobytes()
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2][0].tobytes() == b[2][0].tobytes()
    for k in a[3]:
        np.testing.assert_array_equal(a[3][k], b[3][k])


def test_numpy_backend_uses_native_and_matches_reference(rng):
    """The port's numpy backend (native when built) against the
    reference's numpy backend, bytes equal."""
    import mpi_grid_redistribute_tpu as jgr
    import mpi_grid_redistribute_tpu_torch as tgr

    pos = rng.random((8 * 256, 3), dtype=np.float32)
    kw = dict(grid=(2, 2, 2), lo=0.0, hi=1.0, periodic=True,
              capacity_factor=8.0, backend="numpy")
    got = tgr.GridRedistribute(**kw).redistribute(pos)
    want = jgr.GridRedistribute(**kw).redistribute(pos)
    assert got.positions.tobytes() == want.positions.tobytes()
    assert got.count.tobytes() == want.count.tobytes()
