"""The port's sparse data layer against the JAX package's: every registry
entry, its ELL and SELL-C-σ forms and the padding accounting must give the
same arrays exactly (both are numpy; the port keeps its own copy)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import sparse as jsp
from repro.kernels import spmv_ell as jspmv
from repro_torch import sparse as tsp
from repro_torch.kernels import spmv_ell as tspmv

NAMES = sorted(tsp.REGISTRY)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_registry_is_the_reference_registry():
    assert NAMES == sorted(jsp.REGISTRY)
    assert tsp.PROXY_ONCHIP_BYTES == jsp.PROXY_ONCHIP_BYTES
    assert tsp.symmetric_names() == jsp.symmetric_names()
    assert tsp.irregular_names() == jsp.irregular_names()
    assert tsp.nonsymmetric_names() == jsp.nonsymmetric_names()
    for name in NAMES:
        t, j = tsp.REGISTRY[name], jsp.REGISTRY[name]
        assert (t.kwargs, t.structure, t.symmetric) == \
            (j.kwargs, j.structure, j.symmetric)


@pytest.mark.parametrize("name", NAMES)
def test_generate_and_formats_equal_reference(name):
    t, j = tsp.generate(name), jsp.generate(name)
    assert t.shape == j.shape
    for f in ("indptr", "indices", "data"):
        _same(getattr(t, f), getattr(j, f))
    te, je = t.to_ell(), j.to_ell()
    for f in ("data", "cols", "row_nnz"):
        _same(getattr(te, f), getattr(je, f))
    assert vars(te.padding_report()) == vars(je.padding_report())
    for c, sigma in ((8, 64), (32, 256)):
        ts, js = t.to_sell(c=c, sigma=sigma), j.to_sell(c=c, sigma=sigma)
        for f in ("data", "cols", "slice_offsets", "slice_k", "perm",
                  "row_nnz"):
            _same(getattr(ts, f), getattr(js, f))
        _same(ts.row_positions(), js.row_positions())
        assert (ts.c, ts.sigma, ts.k_max, ts.nnz) == \
            (js.c, js.sigma, js.k_max, js.nnz)
        assert vars(ts.padding_report()) == vars(js.padding_report())
    tname, trep = tsp.choose_format(t)
    jname, jrep = jsp.choose_format(j)
    assert tname == jname
    assert {k: vars(v) for k, v in trep.items()} == \
        {k: vars(v) for k, v in jrep.items()}


def test_small_containers_round_trip_like_the_reference():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((23, 23)).astype(np.float32)
    a[np.abs(a) < 1.0] = 0.0
    a = a + a.T + 8 * np.eye(23, dtype=np.float32)
    t, j = tsp.CSRMatrix.from_dense(a), jsp.CSRMatrix.from_dense(a)
    for f in ("indptr", "indices", "data"):
        _same(getattr(t, f), getattr(j, f))
    _same(t.to_dense(), a)
    _same(t.to_ell().to_dense(), a)
    _same(t.to_sell(c=4, sigma=8).to_dense(), a)
    x = rng.standard_normal(23).astype(np.float32)
    _same(t.matvec(x), j.matvec(x))
    assert t.is_symmetric() and j.is_symmetric()
    with pytest.raises(ValueError, match="cannot hold row"):
        t.to_ell(k=1)


def test_ell_helpers_equal_reference():
    for side in (1, 3, 8):
        for tarr, jarr in zip(tspmv.poisson2d_ell(side),
                              jspmv.poisson2d_ell(side)):
            _same(tarr, jarr)
    a = np.diag(np.arange(1, 6, dtype=np.float32))
    a[0, 4] = a[4, 0] = 0.5
    for tarr, jarr in zip(tspmv.dense_to_ell(a), jspmv.dense_to_ell(a)):
        _same(tarr, jarr)
    with pytest.raises(ValueError, match="cannot hold row"):
        tspmv.dense_to_ell(a, k=1)
