"""The port's CG slice against the JAX reference: the plain SpMVs and CG run,
``CGProblem`` -> ``execute`` on every single-device tier, the cache policy
and the CG planner, and CG plans through JSON.

Inputs are made with numpy from a seed and handed to both packages. The
JAX kernels run as the JAX package's own tests run them on the CPU (Pallas
interpret mode); the port's wrappers run their plain torch versions
because the tensors lie on the CPU. Bounds, from the reference's tests:
the SpMVs at atol 1e-5 (``tests/test_kernels_linalg.py``) plus rtol 1e-5,
since the two packages sum a row in different orders; CG at rtol 1e-3,
atol 1e-5 on x and rr (the same file's fused-CG bound). Within the port
the loop tiers agree bit for bit. The CUDA kernels are held to their plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

from repro import sparse as jsp
from repro.core import cache_policy as jcp
from repro.exec import CGProblem as JaxCGProblem
from repro.exec import Plan as JaxPlan
from repro.exec import execute as jax_execute
from repro.exec import planner as jplanner
from repro.exec.adapters import fused_block_rows as jax_fused_block_rows
from repro.exec.adapters import operator_fingerprint as jax_operator_fp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.solvers import cg as jcg
from repro_torch.convert import (ell_from_reference, plan_from_reference,
                                 sell_from_reference)
from repro_torch.core import cache_policy as tcp
from repro_torch.core import perks
from repro_torch.exec import (CGProblem, Plan, cg_policy, execute,
                              fused_block_rows, operator_fingerprint, plan,
                              plan_candidates)
from repro_torch.exec.adapters import CG_STEP_LAUNCHES
from repro_torch.exec.precision import dot_for
from repro_torch.kernels import ops, ref
from repro_torch.kernels.common import get_spec
from repro_torch.solvers import cg as tcg
from repro_torch.sparse import PROXY_ONCHIP_BYTES, generate, symmetric_names
from repro_torch.sparse.generate import poisson2d

SPMV_TOL = dict(rtol=1e-5, atol=1e-5)
CG_TOL = dict(rtol=1e-3, atol=1e-5)
SPD = symmetric_names()
#: registry entries small enough for the reference's interpret-mode kernels
SMALL = ["poisson2d_small", "poisson3d_16", "graph_regular_4k"]


def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# -- the plain SpMVs ------------------------------------------------------------

@pytest.mark.parametrize("name", SPD)
def test_plain_spmv_matches_reference(name):
    csr = generate(name)
    x = _rhs(csr.shape[0], seed=1)
    ell = csr.to_ell()
    got = ops.spmv(_t(ell.data), _t(ell.cols), _t(x))
    _close(got, jref.spmv_ell(jnp.asarray(ell.data), jnp.asarray(ell.cols),
                              jnp.asarray(x)), SPMV_TOL)
    _close(got, csr.matvec(x), SPMV_TOL)
    sell = csr.to_sell(c=32, sigma=256)
    args = [_t(a) for a in (sell.data, sell.cols, sell.slice_offsets,
                            sell.slice_k, x)]
    got = ops.spmv_sell(*args, c=32, k_max=sell.k_max)
    want = jref.spmv_sell(*[jnp.asarray(np.asarray(a)) for a in args], c=32)
    _close(got, want, SPMV_TOL)
    if name in SMALL:   # the Pallas kernels in interpret mode
        _close(got, jops.spmv_sell(*[jnp.asarray(np.asarray(a))
                                     for a in args], c=32,
                                   k_max=sell.k_max), SPMV_TOL)
        _close(ops.spmv(_t(ell.data), _t(ell.cols), _t(x)),
               jops.spmv(jnp.asarray(ell.data), jnp.asarray(ell.cols),
                         jnp.asarray(x)), SPMV_TOL)


def test_plain_spmv_sell_sums_each_slice_to_its_own_width():
    sell = generate("graph_powerlaw_8k").to_sell(c=8, sigma=64)
    x = _t(_rhs(sell.n_rows, seed=2))
    args = [_t(a) for a in (sell.data, sell.cols, sell.slice_offsets,
                            sell.slice_k)]
    y = ops.spmv_sell(*args, x, c=8, k_max=sell.k_max)
    assert y.shape == (sell.n_slices * 8,)
    # a wider k_max adds only masked zeros: the same result bit for bit
    assert torch.equal(y, ops.spmv_sell(*args, x, c=8, k_max=sell.k_max + 5))
    with pytest.raises(ValueError, match="widest slice"):
        ops.spmv_sell(*args, x, c=8, k_max=sell.k_max - 1)
    op = tcg.SellOperator.from_matrix(sell, "cpu")
    assert torch.equal(op.matvec(x), y[_t(sell.row_positions())])


# -- the plain CG run --------------------------------------------------------------

@pytest.mark.parametrize("side,iters", [(16, 1), (16, 20), (24, 5), (32, 20)])
def test_plain_cg_run_matches_reference(side, iters):
    ell = poisson2d(side).to_ell()
    n = side * side
    b = _rhs(n, seed=side)
    jd, jc, jb = jnp.asarray(ell.data), jnp.asarray(ell.cols), jnp.asarray(b)
    wx, wrr = jref.cg_run(jd, jc, jb, iters)
    x, rr = ref.cg_run(_t(ell.data), _t(ell.cols), _t(b), iters)
    _close(x, wx, CG_TOL)
    _close(rr, wrr, CG_TOL)
    bm = fused_block_rows(n)
    for resident in (True, False):
        gx, grr = jops.cg(jd, jc, jb, iters=iters, resident_matrix=resident,
                          block_rows=bm)
        tx, trr = ops.cg(_t(ell.data), _t(ell.cols), _t(b), iters=iters,
                         resident_matrix=resident, block_rows=bm)
        assert trr.shape == (1,)
        _close(tx, gx, CG_TOL)
        _close(trr, grr, CG_TOL)
        assert torch.equal(tx, x) and torch.equal(trr[0], rr)


def test_safe_div_keeps_converged_iterations_fixed():
    a = torch.tensor([1.0, 2.0, 3.0, 0.0])
    b = torch.tensor([2.0, 0.0, float("nan"), -0.0])
    got = ref._safe_div(a, b)
    want = jref._safe_div(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(want))
    ell = poisson2d(4).to_ell()
    x, rr = ref.cg_run(_t(ell.data), _t(ell.cols), torch.zeros(16), 3)
    assert torch.equal(x, torch.zeros(16)) and float(rr) == 0.0


def test_cg_step_dispatches_what_the_planner_charges():
    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    n = 12
    r = torch.from_numpy(_rhs(n))
    state = (torch.zeros(n), r, r, torch.dot(r, r))
    out = tuple(torch.empty_like(t) for t in state)
    ap = torch.from_numpy(_rhs(n, seed=1))
    with Count() as counted:
        ref.cg_iteration_matvec(state, lambda q: ap, dot=dot_for("uniform"),
                                out=out)
    assert len(counted.ops) + 1 == CG_STEP_LAUNCHES   # + the SpMV


# -- CGProblem -> execute on every tier -------------------------------------------------

def _problems(name="poisson2d_small", iters=12, tol=None):
    csr = generate(name)
    ell = csr.to_ell()
    b = _rhs(csr.shape[0], seed=4)
    jp = JaxCGProblem.from_ell(jnp.asarray(ell.data), jnp.asarray(ell.cols),
                               jnp.asarray(b), iters, matrix=csr, tol=tol)
    tp = CGProblem.from_ell(ell.data, ell.cols, b, iters, matrix=csr,
                            tol=tol, device="cpu")
    return jp, tp


@pytest.mark.parametrize("name", ["poisson2d_small", "poisson3d_16"])
def test_execute_tiers_match_reference(name):
    jp, tp = _problems(name)
    cands = plan_candidates(tp)
    assert {(c.tier, c.policy) for c in cands} == {
        ("host_loop", None), ("device_loop", "IMP"), ("resident", "VEC"),
        ("resident", "MIX")}
    want_x, want_rr = tp.oracle()
    for p in cands + [Plan(tier="device_loop", sync_every=5)]:
        x, rr = execute(tp, p)
        jx, jrr = jax_execute(jp, JaxPlan.from_json(p.to_json()))
        _close(x, jx, CG_TOL)
        _close(rr, jrr, CG_TOL)
        assert rr.shape == ()
        assert torch.equal(x, want_x) and torch.equal(rr, want_rr), p
    assert np.array_equal(tp.b.numpy(), _rhs(tp.b.shape[0], seed=4))


def test_execute_stops_at_tol_like_reference():
    jp, tp = _problems("poisson2d_small", iters=200, tol=1e-4)
    p = plan(tp, sync_every=10)
    assert p.sync_every == 10
    for tier in ("host_loop", "device_loop"):
        tplan = Plan(tier=tier, sync_every=10)
        x, rr = execute(tp, tplan)
        jx, jrr = jax_execute(jp, JaxPlan.from_json(tplan.to_json()))
        _close(x, jx, CG_TOL)
        assert float(rr) < 1e-4 * float(tp.initial_state()[3])
    seen = []
    step = tp.step_fn()
    on_sync = tp.on_sync()
    perks.chunked_loop(step, 200, sync_every=10,
                       on_sync=lambda s, k: seen.append(k) or on_sync(s, k))(
        tp.initial_state())
    assert seen and seen[-1] < 200 and seen == list(range(10, seen[-1] + 1, 10))


def test_default_sync_cadence_follows_reference():
    jp, tp = _problems(iters=60, tol=1e-5)
    jplans = jplanner.plan_candidates(jp)
    assert {c.sync_every for c in plan_candidates(tp)} == \
        {c.sync_every for c in jplans} == {25}
    _, tp = _problems(iters=60)
    assert {c.sync_every for c in plan_candidates(tp)} == {None}


def test_sell_operator_path_matches_reference():
    csr = generate("poisson2d_small")
    b = _rhs(csr.shape[0], seed=6)
    jop = jcg.load_sell("poisson2d_small", c=32, sigma=256)
    top = tcg.load_sell("poisson2d_small", c=32, sigma=256, device="cpu")
    for conv in (top, sell_from_reference(jop, "cpu"),
                 sell_from_reference(jop.matrix, "cpu")):
        for f in ("data", "cols", "slice_offsets", "slice_k", "positions"):
            assert np.array_equal(getattr(conv, f).numpy(),
                                  np.asarray(getattr(jop, f))), f
    jp = JaxCGProblem.from_matvec(jop.matvec, jnp.asarray(b), 8,
                                  matrix=jop.matrix)
    tp = CGProblem.from_matvec(top.matvec, b, 8, matrix=top.matrix,
                               device="cpu")
    cands = plan_candidates(tp)
    assert sorted(c.tier for c in cands) == ["device_loop", "host_loop"]
    outs = []
    for p in cands:
        x, rr = execute(tp, p)
        jx, jrr = jax_execute(jp, JaxPlan.from_json(p.to_json()))
        _close(x, jx, CG_TOL)
        _close(rr, jrr, CG_TOL)
        outs.append(x)
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(NotImplementedError, match="ELL planes"):
        execute(tp, Plan(tier="resident"))


def test_cg_problem_surface_matches_reference():
    jp, tp = _problems("fem_band_8k")
    assert tp.name == jp.name
    assert [vars(a) for a in tp.cacheable_arrays()] == \
        [vars(a) for a in jp.cacheable_arrays()]
    assert vars(tp.halo_spec()) == vars(jp.halo_spec())
    assert tp.kind == jp.kind == "cg"
    assert tp.step_fn() is tp.step_fn()   # one step function per problem
    assert tp.with_precision("uniform") is tp
    assert tp.with_precision("mixed").precision == "mixed"
    with pytest.raises(NotImplementedError, match="mixed"):
        execute(tp, Plan(tier="resident", precision="mixed"))
    with pytest.raises(NotImplementedError, match="distributed"):
        execute(tp, Plan(tier="distributed", shard_axis="data"))
    with pytest.raises(ValueError, match="ELL planes"):
        CGProblem(b=np.zeros(4, np.float32), n_steps=1, device="cpu")
    data, cols = ell_from_reference(jsp.generate("fem_band_8k").to_ell(),
                                    "cpu")
    assert torch.equal(data, tp.data) and torch.equal(cols, tp.cols)
    assert operator_fingerprint(tp.data, tp.cols, None, None) == \
        jax_operator_fp(jp.data, jp.cols, None, None)
    assert tp.batch_key() == tp.batch_key()
    _, other = _problems("fem_band_8k", iters=13)
    assert other.batch_key() != tp.batch_key()


def test_dot_for_runs_uniform_and_names_the_roadmap_for_mixed():
    from repro_torch.exec.precision import compensated_vdot
    from repro_torch.kernels.vdot import vdot
    # vdot: torch.dot on the CPU, csrc/vdot.cu (one order for a pair and
    # for a lane of a batch) on the card
    assert dot_for("uniform") is vdot
    a, b = torch.from_numpy(_rhs(50)), torch.from_numpy(_rhs(50, seed=1))
    assert torch.equal(vdot(a, b), torch.dot(a, b))
    assert dot_for("mixed") is compensated_vdot
    with pytest.raises(ValueError, match="precision"):
        dot_for("double")


# -- cache policy and planner -----------------------------------------------------------

def test_cg_cache_plans_match_reference():
    for n, nnz, budget in itertools.product(
            (1, 100, 4096, 2**20), (0, 5, 5 * 4096, 20 * 2**20),
            (0, 1000, PROXY_ONCHIP_BYTES, 27_600_000, 10**9)):
        ta, ja = tcp.cg_arrays(n, nnz, 4), jcp.cg_arrays(n, nnz, 4)
        assert [vars(a) for a in ta] == [vars(a) for a in ja]
        tplan, jplan = tcp.plan_caching(ta, budget), jcp.plan_caching(ja,
                                                                      budget)
        assert [(a.array.name, a.cached_bytes) for a in tplan.assignments] \
            == [(a.array.name, a.cached_bytes) for a in jplan.assignments]
        assert tplan.traffic_saved_per_step == jplan.traffic_saved_per_step
        assert tcp.plan_caching(ta, budget, reserve_bytes=100).budget_bytes \
            == jcp.plan_caching(ja, budget, reserve_bytes=100).budget_bytes


@pytest.mark.parametrize("name", sorted(jsp.REGISTRY))
def test_cg_policy_matches_reference(name):
    csr = generate(name)
    assert [vars(a) for a in tcp.cg_arrays_for(csr)] == \
        [vars(a) for a in jcp.cg_arrays_for(jsp.generate(name))]
    for budget in (PROXY_ONCHIP_BYTES, 10**8):
        got = cg_policy(matrix=csr, budget_bytes=budget)
        want = jplanner.cg_policy(matrix=jsp.generate(name),
                                  budget_bytes=budget)
        assert got == want


@pytest.mark.parametrize("name", SPD)
def test_cg_candidates_match_reference_at_proxy_budget(name):
    jp, tp = _problems(name, iters=40)
    kw = dict(budget_bytes=PROXY_ONCHIP_BYTES)
    got = plan_candidates(tp, **kw)
    want = jplanner.plan_candidates(jp, **kw)

    def key(p):
        return (p.tier, p.policy, p.block_rows, p.cache, p.sync_every)

    assert sorted(map(key, got), key=repr) == sorted(
        (key(plan_from_reference(p.to_json())) for p in want), key=repr)
    assert got == sorted(got, key=lambda p: p.predicted_s)
    for p in got:   # through JSON to the reference and back
        jplan = JaxPlan.from_json(p.to_json())
        assert plan_from_reference(jplan.to_dict()) == p
        assert json.loads(jplan.to_json()) == json.loads(p.to_json())


def test_planner_regimes_on_the_h100():
    """The chip_smoke shapes, from sizes alone (nothing is built)."""
    h100 = 0.9 * 132 * 232448
    small = tcp.cg_arrays(512 * 512, 1_308_672, 4)
    large = tcp.cg_arrays(1024 * 1024, 5_238_784, 4)
    from repro_torch.exec.planner import cg_policy_from_arrays
    s = cg_policy_from_arrays(small, int(h100))
    l_ = cg_policy_from_arrays(large, int(h100))
    assert s["policy"] == "MIX" and s["matrix_fraction"] == 1.0
    assert l_["policy"] == "MIX" and 0.2 < l_["matrix_fraction"] < 0.3
    assert fused_block_rows(512 * 512) == jax_fused_block_rows(512 * 512)
    for n in (1, 6, 96, 1000, 4096, 12345):
        assert fused_block_rows(n) == jax_fused_block_rows(n)


def test_host_loop_is_charged_per_launch(monkeypatch):
    from repro_torch.exec import planner
    _, tp = _problems(iters=30)
    by = {(c.tier, c.policy): c for c in plan_candidates(tp)}
    o = planner.DISPATCH_OVERHEAD_S
    host, dev = by[("host_loop", None)], by[("device_loop", "IMP")]
    # the same bytes; the host loop pays every launch, the device loop its
    # capture (every launch once) and one replay until its graph is kept
    assert host.predicted_s - 30 * CG_STEP_LAUNCHES * o == pytest.approx(
        dev.predicted_s - (30 * CG_STEP_LAUNCHES + 1) * o)
    monkeypatch.setattr(perks, "graph_cached", lambda *a: True)
    kept = {(c.tier, c.policy): c for c in plan_candidates(tp)}
    # a kept graph replays every launch at GRAPH_LAUNCH_S
    assert kept[("device_loop", "IMP")].predicted_s == pytest.approx(
        dev.predicted_s - 30 * CG_STEP_LAUNCHES
        * (o - planner.GRAPH_LAUNCH_S))


# -- the runners take tuple states ----------------------------------------------------

def test_runners_take_tuple_states_bit_for_bit():
    spec = get_spec("2d9pt")
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.standard_normal((20, 24)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((20, 24)).astype(np.float32))

    def one(x, out):
        return ref.stencil_step(x, spec, out=out)

    def pair(s, out):
        return (one(s[0], out[0]), one(s[1], out[1]))

    for runner in (lambda f: perks.host_loop(f, 7),
                   lambda f: perks.device_loop(f, 7),
                   lambda f: perks.chunked_loop(f, 7, sync_every=3),
                   lambda f: perks.persistent(f, 7, perks.PerksConfig(
                       execution=perks.Execution.HOST_LOOP, fuse_steps=2))):
        got = runner(pair)((a, c))
        assert isinstance(got, tuple) and len(got) == 2
        assert torch.equal(got[0], runner(one)(a))
        assert torch.equal(got[1], runner(one)(c))
    zero = perks.host_loop(pair, 0)((a, c))
    assert torch.equal(zero[0], a) and zero[0].data_ptr() != a.data_ptr()
