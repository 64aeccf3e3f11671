"""The port's ``AsyncSolverService`` (``repro_torch.runtime.solver_service``):
continuous batching over persistent lane groups, every case of the
reference's ``tests/test_async_service.py`` on the port, plus the
reference's engine driven beside it.

The contract: membership may churn (requests admitted into free lanes at
barriers mid-solve, converged lanes retired one by one), yet every served
result is bit for bit the port's own per-instance run of the request under
the same chunked device loop (``Plan(tier="device_loop",
sync_every=chunk)``), and agrees with the reference's per-instance
``execute`` at the reference's bounds: stencils atol 5e-6, the Krylov
solvers rtol 1e-3 / atol 1e-5. The reference's batched runs are not the
ground truth (its vmapped stencils are not bit-equal to its single runs).

Both engines take the same fake tick clock and the same submissions, so
they must reject, shed, admit and retire the same request ids at the same
barriers, with the same queued, latency and exec ticks. Nothing here asserts
a wall-clock duration. All on the CPU, inputs made with numpy from a seed.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.exec import CGProblem as JaxCGProblem
from repro.exec import Plan as JaxPlan
from repro.exec import StencilProblem as JaxStencilProblem
from repro.exec import execute as jax_execute
from repro.exec.krylov import BiCGStabProblem as JaxBiCGStabProblem
from repro.exec.krylov import GMRESProblem as JaxGMRESProblem
from repro.kernels.common import get_spec as jax_get_spec
from repro.runtime.solver_service import AsyncConfig as JaxAsyncConfig
from repro.runtime.solver_service import \
    AsyncSolverService as JaxAsyncSolverService
from repro.runtime.solver_service import \
    ServiceOverloaded as JaxServiceOverloaded
from repro_torch import obs
from repro_torch.core import perks
from repro_torch.exec import (BatchedProblem, BiCGStabProblem, CGProblem,
                              GMRESProblem, Plan, StencilProblem, execute)
from repro_torch.kernels.common import get_spec
from repro_torch.runtime.solver_service import (
    CORE_STATS_KEYS,
    AsyncConfig,
    AsyncSolverService,
    ServiceOverloaded,
)
from repro_torch.solvers.cg import load_matrix

CHUNK = 5
ATOL = 5e-6
KRYLOV_TOL = dict(rtol=1e-3, atol=1e-5)
COUNTERS = ("served", "groups", "barriers", "admitted_mid_solve",
            "retired_early", "rejected", "shed", "sla_misses",
            "distinct_programs", "lane_occupancy")


def _tick_clock():
    ticks = itertools.count()
    return lambda: float(next(ticks))


class _Req:
    """One request in both packages, made from the same numpy arrays: the
    port's problem (``.ours``) and the reference's (``.ref``)."""

    def __init__(self, ours, ref):
        self.ours, self.ref = ours, ref


def _stencil(seed, steps=10, shape=(32, 32)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return _Req(StencilProblem(x, get_spec("2d5pt"), steps, device="cpu"),
                JaxStencilProblem(jnp.asarray(x), jax_get_spec("2d5pt"),
                                  steps))


class _Operator:
    """One ELL operator held by both packages (the instances of a key share
    it: the batch key holds the operands' identity)."""

    def __init__(self, name):
        ell = load_matrix(name).to_ell()
        self.n = ell.data.shape[0]
        self.ours = (torch.from_numpy(ell.data), torch.from_numpy(ell.cols))
        self.ref = (jnp.asarray(ell.data), jnp.asarray(ell.cols))

    def rhs(self, seed):
        return np.random.default_rng(seed).standard_normal(self.n).astype(
            np.float32)

    def cg(self, seed, iters=400, tol=1e-8):
        b = self.rhs(seed)
        return _Req(CGProblem.from_ell(*self.ours, b, iters, tol=tol,
                                       device="cpu"),
                    JaxCGProblem.from_ell(*self.ref, jnp.asarray(b), iters,
                                          tol=tol))

    def bicgstab(self, seed, iters=60, tol=1e-8):
        b = self.rhs(seed)
        return _Req(BiCGStabProblem.from_ell(*self.ours, b, iters, tol=tol,
                                             device="cpu"),
                    JaxBiCGStabProblem.from_ell(*self.ref, jnp.asarray(b),
                                                iters, tol=tol))

    def gmres(self, seed, cycles=6, m=8, tol=1e-10):
        b = self.rhs(seed)
        return _Req(GMRESProblem.from_ell(*self.ours, b, cycles, m=m,
                                          tol=tol, device="cpu"),
                    JaxGMRESProblem.from_ell(*self.ref, jnp.asarray(b),
                                             cycles, m=m, tol=tol))


@pytest.fixture(scope="module")
def poisson():
    return _Operator("poisson_64")


@pytest.fixture(scope="module")
def convdiff():
    return _Operator("convdiff_small")


def _alone(problem, chunk):
    """The request solved alone by the port under the engine's cadence."""
    return execute(problem, Plan(tier="device_loop", sync_every=chunk))


def _leaves(x):
    return x if isinstance(x, tuple) else (x,)


def _assert_same(got, want):
    for g, w in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g, w)


def _assert_served(result, req, chunk):
    """Bit-equal to the port's run alone; close to the reference's."""
    _assert_same(result, _alone(req.ours, chunk))
    want = jax_execute(req.ref, JaxPlan(tier="device_loop",
                                        sync_every=chunk))
    tol = (dict(rtol=0, atol=ATOL) if isinstance(req.ours, StencilProblem)
           else KRYLOV_TOL)
    for g, w in zip(_leaves(result), _leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _engines(**cfg):
    """The port's engine and the reference's, each with its own tick
    clock starting at 0."""
    return (AsyncSolverService(AsyncConfig(**cfg), clock=_tick_clock()),
            JaxAsyncSolverService(JaxAsyncConfig(**cfg), clock=_tick_clock()))


def _schedule(results):
    """What the scheduler decided for each request: its steps and its
    queued, latency and exec ticks."""
    return {rid: (r.steps, r.queued_s, r.latency_s, r.exec_s, r.plan_s > 0)
            for rid, r in results.items()}


def _assert_same_schedule(ours, ref, out_ours, out_ref):
    assert _schedule(out_ours) == _schedule(out_ref)
    s1, s2 = ours.stats(), ref.stats()
    assert {k: s1[k] for k in COUNTERS} == {k: s2[k] for k in COUNTERS}
    assert ours.shed_ids() == ref.shed_ids()


# -- the reference's cases ------------------------------------------------------

def test_mixed_fleet_mid_solve_admission_bit_exact(poisson):
    """Mixed-key fleet, arrivals landing mid-solve: every result is bit for
    bit the request solved alone; groups never mix keys; a key's program
    (runner, lane tensors) is reused across group activations; the
    reference's engine makes the same schedule."""
    eng, ref = _engines(max_batch=4, chunk_steps=CHUNK)
    reqs = [poisson.cg(i) for i in range(3)] + \
        [_stencil(100 + i) for i in range(2)]
    probs = {}
    for r in reqs:
        rid = eng.submit(r.ours)
        assert ref.submit(r.ref) == rid
        probs[rid] = r
    results, ref_results = {}, {}
    for _ in range(2):                       # two barriers of the CG group
        results.update(eng.step())
        ref_results.update(ref.step())
    late = poisson.cg(50)                    # arrives mid-solve
    probs[eng.submit(late.ours)] = late
    ref.submit(late.ref)
    results.update(eng.run_until_idle())
    ref_results.update(ref.run_until_idle())

    assert set(results) == set(probs)
    for rid, r in probs.items():
        _assert_served(results[rid].result, r, CHUNK)
    stats = eng.stats()
    assert stats["served"] == 6
    assert stats["groups"] == 2              # one per key, never mixed
    assert stats["admitted_mid_solve"] >= 1
    assert stats["distinct_programs"] == 2
    assert 0.0 < stats["lane_occupancy"] <= 1.0
    _assert_same_schedule(eng, ref, results, ref_results)
    # a later same-key burst reuses the key's program and lane tensors
    progs = {k: (id(p.runner), p.lanes.steps_done.data_ptr())
             for k, p in eng._programs.items()}
    more = poisson.cg(60)
    rid = eng.submit(more.ours)
    out = eng.run_until_idle()
    _assert_same(out[rid].result, _alone(more.ours, CHUNK))
    assert {k: (id(p.runner), p.lanes.steps_done.data_ptr())
            for k, p in eng._programs.items()} == progs
    assert eng.stats()["groups"] == 3


def _sequential_stop_steps(problem, chunk):
    """Steps a lone chunked run executes before its check stops it."""
    check = problem.on_sync()
    steps = {"n": 0}

    def count(state, k):
        steps["n"] = k
        return check(state, k)

    perks.chunked_loop(problem.step_fn(), problem.n_steps,
                       sync_every=chunk, on_sync=count)(
        problem.initial_state())
    return steps["n"]


def test_per_lane_early_retirement_matches_sequential_stop(poisson):
    """Each converged lane retires at exactly the barrier a lone chunked
    run stops at (per-lane steps equal the sequential stop step), bit for
    bit, never the static batch's slowest-owns-all step count; the
    reference's engine retires the same lanes at the same barriers."""
    eng, ref = _engines(max_batch=4, chunk_steps=CHUNK)
    reqs = [poisson.cg(200 + i) for i in range(4)]
    probs = {}
    for r in reqs:
        probs[eng.submit(r.ours)] = r
        ref.submit(r.ref)
    results = eng.run_until_idle()
    for rid, r in probs.items():
        rr = results[rid]
        assert rr.steps == _sequential_stop_steps(r.ours, CHUNK)
        assert rr.steps < r.ours.n_steps      # genuinely early
        _assert_served(rr.result, r, CHUNK)
    assert eng.stats()["retired_early"] == 4
    _assert_same_schedule(eng, ref, results, ref.run_until_idle())


def test_partial_chunk_tail_is_masked_bit_exact():
    """n_steps not divisible by the chunk: the masked tail (a full chunk,
    the surplus steps discarded lane by lane) matches the sequential
    remainder dispatch bit for bit."""
    eng = AsyncSolverService(AsyncConfig(max_batch=2, chunk_steps=4),
                             clock=_tick_clock())
    r = _stencil(7, steps=10)                # 4 + 4 + masked tail of 2
    rid = eng.submit(r.ours)
    out = eng.run_until_idle()
    _assert_served(out[rid].result, r, 4)
    assert out[rid].steps == 10


def test_backpressure_reject_and_shed():
    eng, ref = _engines(max_batch=2, max_queue=2, overload="reject")
    for i in (0, 1):
        eng.submit(_stencil(i).ours)
        ref.submit(_stencil(i).ref)
    with pytest.raises(ServiceOverloaded, match="queue full"):
        eng.submit(_stencil(2).ours)
    with pytest.raises(JaxServiceOverloaded, match="queue full"):
        ref.submit(_stencil(2).ref)
    assert eng.stats()["rejected"] == ref.stats()["rejected"] == 1
    assert eng.pending() == ref.pending() == 2

    shed, ref_shed = _engines(max_batch=2, max_queue=2, overload="shed")
    oldest = shed.submit(_stencil(0).ours)
    ref_shed.submit(_stencil(0).ref)
    kept = []
    for i in (1, 2):
        kept.append(shed.submit(_stencil(i).ours))
        ref_shed.submit(_stencil(i).ref)
    out, ref_out = shed.run_until_idle(), ref_shed.run_until_idle()
    assert oldest not in out and all(r in out for r in kept)
    assert shed.shed_ids() == ref_shed.shed_ids() == [oldest]
    assert shed.stats()["shed"] == 1 and shed.stats()["served"] == 2
    assert set(out) == set(ref_out)


def test_sla_shed_drops_stale_requests_at_admission():
    """Under overload='shed' with a queue-wait SLA, a request whose wait
    already exceeds the SLA is dropped at admission instead of taking a
    lane; under 'reject' it is served but counted as an SLA miss. Both
    engines decide alike on the same ticks."""
    for overload in ("shed", "reject"):
        clocks = _tick_clock(), _tick_clock()
        engs = (AsyncSolverService(AsyncConfig(
                    max_batch=1, chunk_steps=5, overload=overload,
                    sla_queued_s=30.0), clock=clocks[0]),
                JaxAsyncSolverService(JaxAsyncConfig(
                    max_batch=1, chunk_steps=5, overload=overload,
                    sla_queued_s=30.0), clock=clocks[1]))
        outs = []
        for e, clock, side in zip(engs, clocks, ("ours", "ref")):
            stale = e.submit(getattr(_stencil(0), side))
            for _ in range(40):                  # age it past the SLA
                clock()
            fresh = e.submit(getattr(_stencil(1), side))
            outs.append(e.run_until_idle())
        eng, ref = engs
        if overload == "shed":
            assert fresh in outs[0] and stale not in outs[0]
            assert stale in eng.shed_ids()
        else:
            assert stale in outs[0]
            assert eng.stats()["sla_misses"] >= 1
        _assert_same_schedule(eng, ref, *outs)


def test_seeded_arrival_trace_is_deterministic(poisson):
    """serve() under a seeded arrival trace: everything is served bit for
    bit, two fresh engines given the same trace agree on every scheduling
    counter and percentile (a fake clock and a no-op sleep), and so does
    the reference's engine given the same trace."""
    rng = np.random.default_rng(42)
    offsets = np.cumsum(rng.exponential(40.0, size=8)).tolist()
    mix = [poisson.cg(300 + i) if i % 3 else _stencil(400 + i)
           for i in range(8)]

    def run_once(side="ours"):
        cls, cfg = ((AsyncSolverService, AsyncConfig) if side == "ours"
                    else (JaxAsyncSolverService, JaxAsyncConfig))
        eng = cls(cfg(max_batch=4, chunk_steps=CHUNK), clock=_tick_clock())
        trace = [(t, getattr(r, side)) for t, r in zip(offsets, mix)]
        return eng, eng.serve(trace, sleep=lambda dt: None)

    eng1, out1 = run_once()
    assert len(out1) == 8
    for rid, r in zip(sorted(out1), mix):    # ids in offset order
        _assert_served(out1[rid].result, r, CHUNK)
        assert out1[rid].queued_s >= 0.0
        assert out1[rid].latency_s >= out1[rid].queued_s
    eng2, out2 = run_once()
    s1, s2 = eng1.stats(), eng2.stats()
    assert {k: s1[k] for k in COUNTERS} == {k: s2[k] for k in COUNTERS}
    for k in ("p50_queued_s", "p99_queued_s", "p50_latency_s",
              "p99_latency_s", "p50_exec_s", "p99_exec_s"):
        assert s1[k] == s2[k] >= 0.0
    ref, ref_out = run_once("ref")
    _assert_same_schedule(eng1, ref, out1, ref_out)


def test_engine_rejects_prebatched_and_validates_config():
    eng = AsyncSolverService(clock=_tick_clock())
    bp = BatchedProblem.from_instances([_stencil(0).ours])
    with pytest.raises(TypeError, match="single-instance"):
        eng.submit(bp)
    with pytest.raises(ValueError, match="overload"):
        AsyncConfig(overload="panic")
    with pytest.raises(ValueError, match="max_batch"):
        AsyncConfig(max_batch=0)
    with pytest.raises(ValueError, match="max_queue"):
        AsyncConfig(max_queue=0)
    assert eng.step() == {}                  # an idle engine is a no-op
    assert AsyncConfig().chip == "h100"
    assert JaxAsyncConfig().chip == "tpu_v5e"


def test_cold_activation_charges_plan_time_once(poisson):
    """The cold activation's planning cost lands on the requests admitted
    at activation (plan_s > 0); every later admission of the key reports
    exactly 0.0, as in the reference's engine."""
    eng, ref = _engines(max_batch=2, chunk_steps=CHUNK)
    cold = eng.submit(poisson.cg(500).ours)
    ref.submit(poisson.cg(500).ref)
    out, ref_out = eng.run_until_idle(), ref.run_until_idle()
    assert out[cold].plan_s > 0.0
    assert out[cold].plan_s == ref_out[cold].plan_s
    warm = eng.submit(poisson.cg(501).ours)
    out2 = eng.run_until_idle()
    assert out2[warm].plan_s == 0.0
    assert eng.stats()["plan_s_total"] == out[cold].plan_s


# -- the open-ended chunked loop ----------------------------------------------------

def _counter_step(state, out):
    return torch.add(state, 1.0, out=out)


def test_open_ended_chunked_loop_stops_when_on_barrier_says_so():
    """n_steps=None runs one chunk a barrier until on_barrier stops it,
    advancing the tensor it is given in place; on_barrier runs before
    on_sync and may replace the state."""
    seen = []

    def on_barrier(state, k):
        seen.append(("barrier", k, float(state[0])))
        return state, k >= 9

    def on_sync(state, k):
        seen.append(("sync", k))
        return False

    x = torch.zeros(4)
    run = perks.chunked_loop(_counter_step, None, sync_every=3,
                             on_barrier=on_barrier, on_sync=on_sync)
    out = run(x)
    assert out is x and torch.equal(x, torch.full((4,), 9.0))
    assert seen == [("barrier", 3, 3.0), ("sync", 3), ("barrier", 6, 6.0),
                    ("sync", 6), ("barrier", 9, 9.0)]
    assert run.chunk.captures == 0           # no graph off the card
    # a barrier that hands back other tensors: the loop goes on with them
    y = torch.zeros(2)
    z = perks.chunked_loop(
        _counter_step, None, sync_every=1,
        on_barrier=lambda s, k: ((y, True) if k == 2 else (s, False)))(
            torch.zeros(2))
    assert z is y and torch.equal(y, torch.zeros(2))


@pytest.mark.parametrize("sync_every", [1, 2, 5])
def test_open_ended_chunk_matches_the_bounded_loop(sync_every):
    """The in-place chunk runs the steps a bounded chunked loop runs (one
    step a chunk copies back; longer chunks end in the state's tensors)."""
    spec = get_spec("2d5pt")
    x = np.random.default_rng(3).standard_normal((16, 16)).astype(
        np.float32)
    p = StencilProblem(x, spec, 2 * sync_every, device="cpu")
    state = p.initial_state().clone()
    perks.chunked_loop(p.step_fn(), None, sync_every=sync_every,
                       on_barrier=lambda s, k: (s, k >= 2 * sync_every))(
                           state)
    want = perks.chunked_loop(p.step_fn(), 2 * sync_every,
                              sync_every=sync_every)(p.initial_state())
    assert torch.equal(state, want)


def test_open_ended_chunked_loop_raises_without_on_barrier():
    with pytest.raises(ValueError, match="on_barrier"):
        perks.chunked_loop(_counter_step, None, sync_every=2)
    with pytest.raises(ValueError, match="sync_every"):
        perks.chunked_loop(_counter_step, None, sync_every=0,
                           on_barrier=lambda s, k: (s, True))


def test_bounded_chunked_loop_calls_on_barrier_first():
    """With n_steps the loop keeps its behaviour (a short tail chunk, the
    total exactly n_steps) and calls on_barrier before on_sync."""
    seen = []

    def on_barrier(state, k):
        seen.append(("barrier", k))
        return state, False

    def on_sync(state, k):
        seen.append(("sync", k))
        return False

    out = perks.chunked_loop(_counter_step, 7, sync_every=3,
                             on_barrier=on_barrier, on_sync=on_sync)(
                                 torch.zeros(2))
    assert torch.equal(out, torch.full((2,), 7.0))
    assert seen == [("barrier", 3), ("sync", 3), ("barrier", 6),
                    ("sync", 6), ("barrier", 7), ("sync", 7)]
    stop = perks.chunked_loop(_counter_step, 7, sync_every=3,
                              on_barrier=lambda s, k: (s, k >= 3))(
                                  torch.zeros(2))
    assert torch.equal(stop, torch.full((2,), 3.0))


# -- the Krylov families in the engine ------------------------------------------------

def test_bicgstab_and_gmres_lanes_are_served_bit_exact(convdiff):
    """BiCGStab and GMRES(m) requests, each key with an arrival mid-solve:
    every result is bit for bit its request alone, close to the
    reference's, and lanes retire early on their own tolerance."""
    eng = AsyncSolverService(AsyncConfig(max_batch=3, chunk_steps=2),
                             clock=_tick_clock())
    reqs = [convdiff.bicgstab(600 + i) for i in range(2)] + \
        [convdiff.gmres(700 + i) for i in range(2)]
    probs = {eng.submit(r.ours): r for r in reqs}
    results = dict(eng.step())
    for late in (convdiff.bicgstab(650), convdiff.gmres(750)):
        probs[eng.submit(late.ours)] = late
    results.update(eng.run_until_idle())
    assert set(results) == set(probs)
    for rid, r in probs.items():
        _assert_served(results[rid].result, r, 2)
    s = eng.stats()
    assert s["groups"] == 2 and s["admitted_mid_solve"] >= 1
    assert s["retired_early"] >= 1
    assert eng.graph_captures() == {
        r.ours.name: 0 for r in (reqs[0], reqs[2])}


def test_stats_metrics_and_trace_events_follow_the_reference(poisson):
    """stats() carries CORE_STATS_KEYS and the reference's keys; the
    metrics and the tracer's events have the reference's names; evicting
    the programs empties the cache once the group has drained."""
    tr = obs.Tracer()
    reg = obs.MetricsRegistry()
    eng = AsyncSolverService(AsyncConfig(max_batch=2, chunk_steps=CHUNK),
                             clock=_tick_clock(), metrics=reg, tracer=tr)
    ref = JaxAsyncSolverService(JaxAsyncConfig(max_batch=2,
                                               chunk_steps=CHUNK),
                                clock=_tick_clock())
    eng.submit(poisson.cg(800, iters=20).ours)
    ref.submit(poisson.cg(800, iters=20).ref)
    eng.submit(_stencil(801).ours)
    ref.submit(_stencil(801).ref)
    eng.run_until_idle()
    ref.run_until_idle()
    assert CORE_STATS_KEYS <= set(eng.stats())
    assert set(eng.stats()) == set(ref.stats())
    names = {e.name for e in tr.events}
    assert {"chunk", "barrier", "lane_compile"} <= names
    assert any(n.startswith("drive:") for n in names)
    assert reg.value("async_barriers_total") == eng.stats()["barriers"]
    assert set(eng.graph_captures().values()) == {0}    # none off the card
    assert len(eng.chosen_plans()) == 2
    assert all(p.tier == "device_loop" and p.batch == 2
               for p in eng.chosen_plans().values())
    assert eng.evict_programs() == 2 and eng.stats()["distinct_programs"] == 0
