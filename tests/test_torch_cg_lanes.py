"""The batched ``cg_fused`` (``csrc/cg_fused.cu``, B <= 32 right-hand sides
in one launch) on the CPU: the launch's shared-memory layout that the
wrapper and the planner share, a numpy model of the kernel's multi-value
warp reduction against the butterfly it replaces, and the port's batched
CG against the JAX package's ``cg_fused``, lane by lane.

The layout is checked against a stand-in for the built library that
reports the H100's per-block shared memory (``hardware.H100``) and the
kernel's static shared memory (``cg_fused.STATIC_SMEM_BYTES``; the card
test ``test_cuda_cg_fused_static_smem_is_the_planners`` holds the built
kernel to both). The reduction model adds in float32 exactly as the
kernel does (``krylov_common.cuh`` ``warp_sums`` and ``warp_sum``), so
the two must agree bit for bit. The JAX kernel runs as the JAX package's
own tests run it on the CPU (Pallas interpret mode); the port's wrapper
runs its plain torch version because the tensors lie on the CPU. Bound:
the reference's fused-CG bound, rtol 1e-3, atol 1e-5 on x and rr
(``tests/test_kernels_linalg.py``), since the two packages sum the dots
in different orders.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from _hyp import given, settings, st

from repro.kernels import ops as jops
from repro_torch.core.hardware import H100
from repro_torch.exec import CGProblem, plan_candidates, planner
from repro_torch.exec.adapters import fused_block_rows, plan_matrix_rows
from repro_torch.kernels import cg_fused as kcg
from repro_torch.kernels import ops, ref
from repro_torch.sparse.generate import poisson2d

CG_TOL = dict(rtol=1e-3, atol=1e-5)
LANES = range(1, kcg.MAX_LANES + 1)
#: (n, k): poisson2d at 128-1024 (the batched cells' operators), a 3D
#: operator and n that no grid or lane width divides
SHAPES = [(128 * 128, 5), (256 * 256, 5), (512 * 512, 5), (1024 * 1024, 5),
          (13 ** 3, 7), (300007, 5)]


class _Lib:
    """The two entry points ``_build.fit`` asks of a built ``cg_fused``:
    the H100's opt-in shared memory and the kernel's static shared memory,
    and one CTA an SM."""

    def cg_fused_smem(self, optin, static):
        optin._obj.value = H100.smem_per_block
        static._obj.value = kcg.STATIC_SMEM_BYTES
        return 0

    def cg_fused_max_ctas(self, smem, out):
        out._obj.value = H100.sms
        return 0


def _wrapper_fit(n, k, rows, lanes):
    """The wrapper's (stride, ca, smem), or None where it refuses."""
    try:
        return kcg.fit(_Lib(), n, k, H100.sms, rows, lanes)
    except ValueError as e:
        assert "holds at most" in str(e)
        return None


def _problem(n, k):
    return types.SimpleNamespace(data=torch.empty((n, k)),
                                 b=torch.empty(n))


@pytest.mark.parametrize("n,k", SHAPES)
def test_layout_is_the_wrappers_and_the_planners(n, k):
    for lanes in LANES:
        lb = kcg.lane_width(lanes)
        assert lb >= lanes and lb & (lb - 1) == 0 and lb < 2 * lanes
        for rows in (0, n // 3, n):
            stride, ca, smem = kcg.smem_layout(n, k, H100.sms, rows, lanes)
            assert stride == -(-n // H100.sms)
            assert ca == min(stride, -(-rows // H100.sms))
            # warp partials, x r p Ap a row a lane, 8 B a cached slot; the
            # padded lanes counted
            assert smem == 128 * lb + 16 * lb * stride + 8 * k * ca
            got = _wrapper_fit(n, k, rows, lanes)
            fits = planner._cg_lanes_fit(_problem(n, k), H100, lanes, rows)
            assert fits == (got is not None), (n, lanes, rows)
            if got is not None:
                assert got == (stride, ca, smem)
    assert not planner._cg_lanes_fit(_problem(n, k), H100,
                                     kcg.MAX_LANES + 1, 0)


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 5, 8, 16, 32])
def test_planner_offers_exactly_the_batched_resident_plans_that_fit(
        batch, monkeypatch):
    """Every batched resident candidate is one the wrapper launches, and
    none that it would launch is dropped."""
    ell = poisson2d(512).to_ell()
    n, k = ell.data.shape
    b = np.zeros(n, np.float32)
    p = CGProblem.from_ell(ell.data, ell.cols, b, 10, device="cpu")
    got = [c for c in plan_candidates(p, batch=batch)
           if c.tier == "resident"]
    monkeypatch.setattr(planner, "_cg_lanes_fit", lambda *a: True)
    every = [c for c in plan_candidates(p, batch=batch)
             if c.tier == "resident"]
    want = [c for c in every if batch == 1 or _wrapper_fit(
        n, k, plan_matrix_rows(c, n), batch) is not None]
    assert got == want
    if batch in (3, 4):          # cg-batch-small's MIX, padded or not
        assert any(c.policy == "MIX" for c in got)


def _butterfly(v):
    """warp_sum over 32 threads, float32: every thread's sum."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ o]
    return v


def _halving(v):
    """warp_sums<LB> over 32 threads of LB values each (v: (32, LB),
    float32): thread L's returned sum."""
    lanes = np.arange(32)
    m, o = v.shape[1], 16
    while m > 1:
        upper = ((lanes & o) != 0)[:, None]
        keep = np.where(upper, v[:, m // 2:m], v[:, :m // 2])
        give = np.where(upper, v[:, :m // 2], v[:, m // 2:m])
        v = keep + give[lanes ^ o]
        m, o = m // 2, o // 2
    s = v[:, 0]
    while o > 0:
        s = s + s[lanes ^ o]
        o //= 2
    return s


def _check_warp_sums(vals, lanes):
    lb = kcg.lane_width(lanes)
    v = np.zeros((32, lb), np.float32)          # padded lanes hold zeros
    v[:, :lanes] = vals[:, :lanes]
    got = _halving(v)
    assert got.dtype == np.float32
    for lane in range(32):
        value = lane // (32 // lb)
        want = _butterfly(v[:, value])
        assert want.dtype == np.float32
        assert np.all(want.view(np.uint32) == want[0].view(np.uint32))
        assert got[lane].view(np.uint32) == want[0].view(np.uint32), (
            lanes, lane, value)


@pytest.mark.parametrize("lanes", LANES)
def test_warp_sums_model_is_the_butterfly_bit_for_bit(lanes):
    rng = np.random.default_rng(lanes)
    # magnitudes 2^-40 .. 2^40 and zeros of both signs, so sums round
    vals = (rng.standard_normal((32, 32))
            * np.exp2(rng.integers(-40, 41, (32, 32)))).astype(np.float32)
    vals[rng.random((32, 32)) < 0.1] = 0.0
    vals[rng.random((32, 32)) < 0.05] = -0.0
    _check_warp_sums(vals, lanes)


@settings(max_examples=200, deadline=None)
@given(data=st.data())
def test_warp_sums_model_is_the_butterfly_for_any_values(data):
    lanes = data.draw(st.integers(1, 32), label="lanes")
    vals = data.draw(st.lists(
        st.floats(width=32, allow_nan=False, allow_infinity=False),
        min_size=32 * lanes, max_size=32 * lanes), label="vals")
    with np.errstate(over="ignore", invalid="ignore"):
        _check_warp_sums(np.array(vals, np.float32).reshape(32, lanes),
                         lanes)


@pytest.mark.parametrize("lanes", [1, 3, 8])
def test_batched_cg_matches_reference_lane_by_lane(lanes):
    side, iters = 16, 20
    ell = poisson2d(side).to_ell()
    n = side * side
    bs = np.random.default_rng(lanes).standard_normal((lanes, n)).astype(
        np.float32)
    data, cols = torch.from_numpy(ell.data), torch.from_numpy(ell.cols)
    x, rr = ops.cg(data, cols, torch.from_numpy(bs), iters=iters)
    assert x.shape == (lanes, n) and rr.shape == (lanes,)
    jd, jc = jnp.asarray(ell.data), jnp.asarray(ell.cols)
    for i in range(lanes):
        x1, rr1 = ops.cg(data, cols, torch.from_numpy(bs[i]), iters=iters)
        assert torch.equal(x[i], x1) and torch.equal(rr[i], rr1[0])
        wx, wrr = jops.cg(jd, jc, jnp.asarray(bs[i]), iters=iters,
                          resident_matrix=True, block_rows=fused_block_rows(n))
        torch.testing.assert_close(x[i], torch.tensor(np.asarray(wx)),
                                   **CG_TOL)
        torch.testing.assert_close(rr[i], torch.tensor(
            np.asarray(wrr)).reshape(()), **CG_TOL)
