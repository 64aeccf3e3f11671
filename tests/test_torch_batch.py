"""The port's batched execution (``repro_torch.exec.batch``) against its own
per-instance runs and the JAX reference's.

The contract is the reference's: a B-wide batched dispatch computes what B
single-instance dispatches compute, bit for bit, on every tier it runs.
Within the port the batched host_loop and device_loop (and CG's batched
resident ``cg_fused``) are bit-equal to the port's ``execute_sequential``
(the batched resident stencil tier: ``test_torch_stencil_lanes.py``);
against the reference's ``execute_sequential`` they agree at the
reference's bounds (stencils atol 5e-6, rtol 0; CG rtol 1e-3, atol 1e-5).
The reference's own batched stencil runs are not the ground truth here:
its per-instance runs are. Plus the lane runner, padding, the one-reduction
convergence check, and the planner's B-scaled working set.

Inputs are made with numpy from a seed and handed to both packages; all on
the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.exec import CGProblem as JaxCGProblem
from repro.exec import BatchedProblem as JaxBatchedProblem
from repro.exec import Problem as JaxProblem
from repro.exec import execute as jax_execute
from repro.exec import Plan as JaxPlan
from repro.exec import StencilProblem as JaxStencilProblem
from repro.exec import execute_sequential as jax_execute_sequential
from repro.kernels.common import get_spec as jax_get_spec
from repro_torch import obs
from repro_torch.core import perks
from repro_torch.core.hardware import H100
from repro_torch.exec import (BatchedProblem, BiCGStabProblem, CGProblem,
                              LaneRunner, Plan, Problem, StencilProblem,
                              autotune_batch_sweep, execute,
                              execute_sequential, per_instance_chip, plan,
                              plan_candidates)
from repro_torch.kernels.common import BENCHMARKS, get_spec
from repro_torch.solvers.cg import load_matrix
from repro_torch.sparse.generate import poisson2d

B = 3
STEPS = 3
ATOL = 5e-6
CG_TOL = dict(rtol=1e-3, atol=1e-5)
NAMES = sorted(BENCHMARKS)


def _domains(spec, b=B, seed=0):
    shape = (48, 64) if spec.ndim == 2 else (24, 16, 32)
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(b)]


def _stencils(name, b=B, steps=STEPS, seed=0):
    spec = get_spec(name)
    xs = _domains(spec, b, seed)
    return xs, [StencilProblem(x, spec, steps, device="cpu") for x in xs]


def _ell(dataset):
    """One operator's ELL planes as tensors: the instances of a batch share
    them (the batch key holds the operands' identity). ``"poisson_16"`` is
    a 16x16 grid, for the runs to convergence."""
    csr = poisson2d(16) if dataset == "poisson_16" else load_matrix(dataset)
    ell = csr.to_ell()
    return torch.from_numpy(ell.data), torch.from_numpy(ell.cols)


def _rhs(n, b=B, seed=10):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(b)]


def _cgs(dataset, iters, b=B, seed=10, tol=None):
    data, cols = _ell(dataset)
    bs = _rhs(data.shape[0], b, seed)
    return data, cols, bs, [CGProblem.from_ell(data, cols, v, iters, tol=tol,
                                               device="cpu") for v in bs]


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _split_equal(bp, out, seq):
    parts = bp.split(out)
    assert len(parts) == len(seq)
    for got, want in zip(parts, seq):
        _same(got, want)


# -- all 13 stencil specs ----------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_batched_stencil_matches_sequential(name):
    xs, insts = _stencils(name)
    bp = BatchedProblem.from_instances(insts)
    jinsts = [JaxStencilProblem(jnp.asarray(x), jax_get_spec(name), STEPS)
              for x in xs]
    want = jax_execute_sequential(jinsts, JaxPlan(tier="host_loop"))
    for tier in ("host_loop", "device_loop"):
        single = Plan(tier=tier)
        out = execute(bp, dataclasses.replace(single, batch=B))
        assert out.shape == (B,) + insts[0].x.shape
        _split_equal(bp, out, execute_sequential(insts, single))
        for got, w in zip(bp.split(out), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=0, atol=ATOL)


def test_batched_oracle_split_and_single_plan_refusal():
    _, insts = _stencils("2d5pt")
    bp = BatchedProblem.from_instances(insts)
    orc = bp.oracle()
    assert orc.shape == (B,) + insts[0].x.shape
    for i, inst in enumerate(insts):
        assert torch.equal(orc[i], inst.oracle())
    with pytest.raises(ValueError, match="batch"):
        execute(bp, Plan(tier="device_loop"))
    with pytest.raises(ValueError, match="batch"):
        execute(insts[0], Plan(tier="device_loop", batch=B))
    with pytest.raises(ValueError, match="single-instance"):
        execute_sequential(insts, Plan(tier="host_loop", batch=B))
    chosen = plan(bp)
    assert chosen.batch == B and chosen.problem == bp.name
    with pytest.raises(ValueError, match="conflicts"):
        plan_candidates(bp, batch=B + 1)


def test_batched_problem_rejects_mixed_and_unbatched_instances():
    (x,), (a,) = _stencils("2d5pt", b=1)
    _, (c,) = _stencils("2d9pt", b=1)
    with pytest.raises(ValueError, match="batch-compatible"):
        BatchedProblem.from_instances([a, c])
    with pytest.raises(ValueError, match="nest"):
        BatchedProblem.from_instances([BatchedProblem.from_instances([a])])
    with pytest.raises(ValueError, match="pad_to"):
        BatchedProblem.from_instances([a, a], pad_to=1)
    with pytest.raises(ValueError):
        BatchedProblem.from_instances([])
    data, cols = _ell("poisson2d_small")
    v = _rhs(data.shape[0], 1)[0]
    # BiCGStab batches given as ELL planes; over a matvec callable it has
    # no batched launch
    bi = BiCGStabProblem.from_matvec(lambda q: q, v, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="bicgstab"):
        BatchedProblem.from_instances([bi, bi])


def test_batch_keys_separate_operators_and_families():
    data, cols = _ell("poisson_64")
    v = _rhs(data.shape[0], 1)[0]
    p1 = CGProblem.from_ell(data, cols, v, 4, device="cpu")
    p2 = CGProblem.from_ell(data.clone(), cols, v, 4, device="cpu")
    assert p1.batch_key() != p2.batch_key()
    (_, (s1,)), (_, (s2,)) = _stencils("2d5pt", 1), _stencils("3d7pt", 1)
    assert s1.batch_key() != s2.batch_key() != p1.batch_key()
    assert s1.batch_key() == _stencils("2d5pt", 1, seed=4)[1][0].batch_key()


# -- padding ------------------------------------------------------------------------


def test_padding_replicates_and_is_dropped():
    _, insts = _stencils("2d5pt", b=2)
    bp = BatchedProblem.from_instances(insts, pad_to=4)
    assert bp.batch == 4 and bp.pad == 2
    out = execute(bp, Plan(tier="device_loop", batch=4))
    assert out.shape[0] == 4 and len(bp.split(out)) == 2
    _split_equal(bp, out, execute_sequential(insts, Plan(tier="device_loop")))


def test_with_payload_preserves_padding():
    _, insts = _stencils("2d5pt", b=2)
    bp = BatchedProblem.from_instances(insts, pad_to=4)
    clone = bp.with_payload(bp.payload())
    assert clone.batch == 4 and clone.pad == 2
    assert len(clone.split(clone.oracle())) == 2
    assert torch.equal(clone.payload_stack, bp.payload_stack)
    # a copy with a new payload shares the instance's step (its graphs)
    assert insts[0].with_payload(insts[1].x).step_fn() is insts[0].step_fn()


# -- conjugate gradient ---------------------------------------------------------------


@pytest.mark.parametrize("dataset", ["poisson2d_small", "fem_band_8k",
                                     "poisson_64"])
def test_batched_cg_matches_sequential(dataset):
    data, cols, bs, insts = _cgs(dataset, 4)
    bp = BatchedProblem.from_instances(insts)
    jinsts = [JaxCGProblem.from_ell(jnp.asarray(data.numpy()), jnp.asarray(cols.numpy()),
                                    jnp.asarray(v), 4) for v in bs]
    want = jax_execute_sequential(jinsts, JaxPlan(tier="host_loop"))
    singles = [Plan(tier="host_loop"), Plan(tier="device_loop"),
               Plan(tier="resident", policy="MIX", block_rows=256)]
    for single in singles:
        out = execute(bp, dataclasses.replace(single, batch=B))
        assert out[0].shape == (B, data.shape[0]) and out[1].shape == (B,)
        _split_equal(bp, out, execute_sequential(insts, single))
        for (x, rr), (jx, jrr) in zip(bp.split(out), want):
            np.testing.assert_allclose(x.numpy(), np.asarray(jx), **CG_TOL)
            np.testing.assert_allclose(float(rr), float(jrr), **CG_TOL)


def test_batched_cg_resident_matches_the_reference_resident():
    data, cols, bs, insts = _cgs("poisson_64", 5, seed=20)
    bp = BatchedProblem.from_instances(insts)
    single = Plan(tier="resident", policy="MIX", block_rows=256)
    out = execute(bp, dataclasses.replace(single, batch=B))
    _split_equal(bp, out, execute_sequential(insts, single))
    # the reference's fused Pallas kernel, in interpret mode, one instance
    jp = JaxCGProblem.from_ell(jnp.asarray(data.numpy()), jnp.asarray(cols.numpy()),
                               jnp.asarray(bs[0]), 5)
    (jx, jrr), = jax_execute_sequential([jp], JaxPlan.from_json(
        single.to_json()))
    x, rr = bp.split(out)[0]
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **CG_TOL)
    np.testing.assert_allclose(float(rr), float(jrr), **CG_TOL)


def test_batched_cg_early_stop_converges_all_instances():
    _, _, bs, insts = _cgs("poisson_16", 500, seed=30, tol=1e-10)
    bp = BatchedProblem.from_instances(insts)
    dev = next(c for c in plan_candidates(bp) if c.tier == "device_loop")
    assert dev.sync_every is not None and dev.batch == B
    assert "resident" not in {c.tier for c in plan_candidates(bp)} or all(
        c.tier != "resident" or c.sync_every for c in plan_candidates(bp))
    x, rr = execute(bp, dev)
    assert x.shape[0] == B
    for i, v in enumerate(bs):
        assert float(rr[i]) < 1e-10 * float(np.dot(v, v)) * 10
    seq = execute_sequential(insts, dataclasses.replace(dev, batch=1))
    # every lane stops at the batch's last check: at or past its own
    for i, (_, rr1) in enumerate(seq):
        assert float(rr[i]) <= float(rr1) or float(rr1) < 1e-30


def test_batched_on_sync_is_one_stacked_reduction(monkeypatch):
    _, _, bs, insts = _cgs("poisson_16", 500, seed=60, tol=1e-10)
    bp = BatchedProblem.from_instances(insts)

    def _boom(self):
        raise AssertionError("per-instance on_sync must not be consulted")

    monkeypatch.setattr(CGProblem, "on_sync", _boom)
    pred, params = bp.convergence()
    lanes = pred(bp.initial_state(), params)
    assert lanes.shape == (B,) and lanes.dtype == torch.bool
    check = bp.on_sync()
    assert check(bp.initial_state(), 0) is False
    x, rr = execute(bp, Plan(tier="device_loop", sync_every=25, batch=B))
    for i, v in enumerate(bs):
        assert float(rr[i]) < 1e-10 * float(np.dot(v, v)) * 10


class _Counter(Problem):
    """A callback-only instance: its state counts the steps taken, and it
    declares no ``convergence()``, only an ``on_sync`` that stops once the
    count reaches ``stop_at`` (its lane's own threshold)."""

    kind = name = "counter"

    def __init__(self, stop_at, n_steps=40, callback=True):
        self.stop_at, self.n_steps, self.callback = stop_at, n_steps, callback

    def initial_state(self):
        return torch.zeros(1)

    def step_fn(self):
        return lambda s, out: torch.add(s, 1.0, out=out)

    batched_step_fn = step_fn

    def batched_tiers(self):
        return ("host_loop", "device_loop")

    def cacheable_arrays(self, *, fuse_steps=1):
        return []

    def oracle(self):
        return torch.full((1,), float(self.n_steps))

    def with_payload(self, payload):
        return self

    def on_sync(self):
        if not self.callback:
            return None
        return lambda state, k: float(state[0]) >= self.stop_at


class _JaxCounter(JaxProblem):
    """``_Counter`` in the reference's package."""

    kind = name = "counter"

    def __init__(self, stop_at, n_steps=40):
        self.stop_at, self.n_steps = stop_at, n_steps

    def initial_state(self):
        return jnp.zeros(1, jnp.float32)

    def step_fn(self):
        return lambda s: s + 1.0

    def cacheable_arrays(self, *, fuse_steps=1):
        return []

    def oracle(self):
        return jnp.full((1,), float(self.n_steps))

    def with_payload(self, payload):
        return self

    def on_sync(self):
        return lambda state, k: float(state[0]) >= self.stop_at


def _stops(seed=80):
    return [int(v) for v in np.random.default_rng(seed).integers(3, 30, B)]


@pytest.mark.parametrize("plan_", [Plan(tier="host_loop", batch=B),
                                   Plan(tier="device_loop", sync_every=1,
                                        batch=B)],
                         ids=["host_loop", "device_loop"])
def test_batched_on_sync_falls_back_to_each_lane_callback(plan_):
    """No instance declares ``convergence()``: the batch checks each lane's
    own callback on that lane's slice and stops at its slowest lane."""
    stops = _stops()
    bp = BatchedProblem.from_instances([_Counter(s) for s in stops])
    assert bp.convergence() is None
    check = bp.on_sync()
    assert check is not None
    state = torch.tensor([[float(s)] for s in stops])
    assert check(state, 0) is True
    state[int(np.argmax(stops)), 0] -= 1
    assert check(state, 0) is False
    out = execute(bp, plan_)
    assert out.shape == (B, 1)
    assert torch.equal(out, torch.full((B, 1), float(max(stops))))


def test_batched_on_sync_is_none_when_one_lane_has_no_callback():
    stops = _stops()
    insts = [_Counter(s) for s in stops[:-1]]
    insts.append(_Counter(stops[-1], callback=False))
    bp = BatchedProblem.from_instances(insts)
    assert bp.on_sync() is None
    out = execute(bp, Plan(tier="host_loop", batch=B))
    assert torch.equal(out, torch.full((B, 1), 40.0))


def test_batched_on_sync_fallback_step_count_matches_the_reference():
    """The same numpy-made thresholds through the reference's
    ``BatchedProblem`` and the port's stop at the same step."""
    stops = _stops(seed=81)
    ours = execute(BatchedProblem.from_instances([_Counter(s) for s in stops]),
                   Plan(tier="host_loop", batch=B))
    jbp = JaxBatchedProblem.from_instances([_JaxCounter(s) for s in stops])
    theirs = jax_execute(jbp, JaxPlan(tier="host_loop", batch=B))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert float(ours[0, 0]) == max(stops)


def test_batched_cg_over_a_matvec_raises_naming_the_kernel():
    data, cols = _ell("poisson_64")
    v = _rhs(data.shape[0], 1)[0]
    mv = lambda p: p
    p = CGProblem.from_matvec(mv, v, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="spmv_sell"):
        BatchedProblem.from_instances([p, p.with_payload(torch.ones(len(v)))])


def test_batched_cg_working_set_shares_matrix():
    _, _, _, insts = _cgs("poisson_64", 4, b=4)
    bp = BatchedProblem.from_instances(insts)
    single = {a.name: a.bytes for a in insts[0].cacheable_arrays()}
    batched = {a.name: a.bytes for a in bp.cacheable_arrays()}
    assert batched["A"] == single["A"]
    for name in ("r", "p", "x", "Ap"):
        assert batched[name] == 4 * single[name]


# -- the lane runner -------------------------------------------------------------------


def test_lane_runner_retirement_bit_exact_vs_sequential():
    """Staggered admission and per-lane early retirement compute what each
    instance computes alone under the same chunked device loop."""
    _, _, _, insts = _cgs("poisson_16", 400, seed=70, tol=1e-8)
    chunk, n = 5, 400
    runner = LaneRunner(insts[0], width=4)
    lanes = runner.fresh()
    lanes = runner.admit(lanes, 0, insts[0])
    lanes = runner.admit(lanes, 2, insts[1])
    admitted_at = {0: 0, 2: 0}
    done = {}
    barrier = 0
    while len(done) < 3:
        runner.advance(lanes, chunk)
        barrier += 1
        conv = runner.convergence_vector(lanes)
        for lane, inst_i in ((0, 0), (2, 1), (1, 2)):
            if inst_i in done or lane not in admitted_at:
                continue
            steps = min((barrier - admitted_at[lane]) * chunk, n)
            if bool(conv[lane]) or steps >= n:
                done[inst_i] = (runner.harvest(lanes, lane), steps)
                lanes = runner.retire(lanes, lane)
                if 2 not in done and 1 not in admitted_at:
                    lanes = runner.admit(lanes, 1, insts[2])
                    admitted_at[1] = barrier
    for i, inst in enumerate(insts):
        want = execute(inst, Plan(tier="device_loop", sync_every=chunk))
        got, steps = done[i]
        assert steps < n
        _same(got, want)


def test_lane_runner_keeps_frozen_lanes_and_rejects_a_foreign_key():
    _, insts = _stencils("2d5pt", b=2)
    runner = LaneRunner(insts[0], width=2)
    lanes = runner.admit(runner.fresh(), 0, insts[0])
    frozen = lanes.state[1].clone()
    addr = lanes.state.data_ptr()
    runner.advance(lanes, STEPS)
    assert torch.equal(lanes.state[1], frozen)
    assert lanes.state.data_ptr() == addr         # admit/advance in place
    _same(runner.harvest(lanes, 0), execute(insts[0],
                                            Plan(tier="host_loop")))
    other = StencilProblem(np.zeros((24, 32), np.float32), get_spec("2d5pt"),
                           STEPS, device="cpu")
    with pytest.raises(ValueError, match="batch key"):
        runner.admit(runner.fresh(), 0, other)
    with pytest.raises(TypeError, match="single-instance"):
        LaneRunner(BatchedProblem.from_instances(insts), width=2)


# -- the planner -----------------------------------------------------------------------


def test_planner_per_instance_budget_shrinks_with_batch_and_a_does_not_scale():
    assert per_instance_chip(H100, 1) is H100
    assert per_instance_chip(H100, 4).onchip_bytes == H100.onchip_bytes / 4
    data, cols = _ell("poisson_64")
    v = _rhs(data.shape[0], 1)[0]
    p = CGProblem.from_ell(data, cols, v, 50, device="cpu")
    a_bytes = {a.name: a.bytes for a in p.cacheable_arrays()}["A"]
    budget = 4 * a_bytes            # A and a few lanes of vectors
    seen = []
    for b in (1, 2, 4, 8, 16):
        cands = plan_candidates(p, batch=b, budget_bytes=budget)
        assert all(c.batch == b for c in cands)
        mix = next((c for c in cands if c.policy == "MIX"), None)
        if mix is not None:
            a = next(c for c in mix.cache if c.name == "A")
            assert a.total_bytes == a_bytes       # one copy for the batch
            vec = sum(c.total_bytes for c in mix.cache if c.name != "A")
            assert vec == b * sum(v for k, v in a_bytes_items(p) if k != "A")
        seen.append(mix is not None)
    assert seen[0] and not seen[-1]               # large batches demote


def a_bytes_items(p):
    return [(a.name, a.bytes) for a in p.cacheable_arrays()]


def test_batched_resident_cg_is_offered_only_where_its_lanes_fit():
    data, cols = _ell("poisson2d_small")
    v = _rhs(data.shape[0], 1)[0]
    p = CGProblem.from_ell(data, cols, v, 20, device="cpu")
    assert "resident" in {c.tier for c in plan_candidates(p, batch=4)}
    assert "resident" not in {c.tier for c in plan_candidates(p, batch=33)}


def test_plan_batch_field_round_trip_and_validation():
    p = Plan(tier="device_loop", batch=8, n_steps=5)
    assert Plan.from_json(p.to_json()) == p
    assert Plan.from_dict(p.to_dict()).batch == 8
    with pytest.raises(ValueError):
        Plan(tier="device_loop", batch=0)


def test_autotune_batch_sweep_returns_per_width_winners():
    _, insts = _stencils("2d5pt", b=4)
    res = autotune_batch_sweep(insts, batches=(1, 4), top_k=2, warmup=0,
                               iters=1, ledger=obs.DriftLedger())
    assert set(res) == {1, 4}
    for b, r in res.items():
        assert r.best.batch == b
        assert all(row.measured_s > 0 for row in r.table)
    with pytest.raises(ValueError, match="instances"):
        autotune_batch_sweep(insts, batches=(8,))


def test_batched_step_is_one_step_function_per_batch():
    """The batched tiers run ONE step function over the stacked state: the
    instance's own, which takes [B, ...] as B domains."""
    _, insts = _stencils("2d5pt")
    bp = BatchedProblem.from_instances(insts)
    assert bp.step_fn() is insts[0].step_fn()
    state = bp.initial_state()
    assert state.shape == (B,) + insts[0].x.shape
    assert bp.initial_state() is state
    assert not perks.graph_cached(bp.step_fn(), state, STEPS)
