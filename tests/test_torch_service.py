"""The port's ``SolverService`` (``repro_torch.runtime.solver_service``):
queue -> pack -> one batched dispatch, the cases of the reference's
``tests/test_service.py`` that apply to the synchronous service, on stencil
and CG requests.

Requests with different batch keys (another stencil, another operator,
another shape) never share a dispatch; FIFO holds by the oldest key;
padding is invisible; a key's plan and loop-tier runner are made once and
reused; a declared convergence check is honoured; and every request's
result is bit-equal to solving it alone with ``execute`` under the batch's
plan. All on the CPU, with numpy inputs from a seed.
"""
import dataclasses
import itertools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs
from repro_torch.exec import (BatchedProblem, CGProblem, Plan,
                              StencilProblem, execute, execute_sequential)
from repro_torch.exec.executor import honors_on_sync
from repro_torch.kernels.common import get_spec
from repro_torch.runtime.solver_service import (
    CORE_STATS_KEYS,
    RequestResult,
    ServiceConfig,
    SolverService,
)
from repro_torch.solvers.cg import load_matrix
from repro_torch.sparse.generate import banded_spd, poisson2d

STEPS = 4


def _stencil(name, seed, shape=None, steps=STEPS):
    spec = get_spec(name)
    shape = shape or ((32, 32) if spec.ndim == 2 else (16, 12, 8))
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return StencilProblem(x, spec, steps, device="cpu")


@pytest.fixture(scope="module")
def poisson():
    ell = load_matrix("poisson_64").to_ell()
    return torch.from_numpy(ell.data), torch.from_numpy(ell.cols)


def _cg(data, cols, seed, iters=STEPS, tol=None):
    b = np.random.default_rng(seed).standard_normal(
        data.shape[0]).astype(np.float32)
    return CGProblem.from_ell(data, cols, b, iters, tol=tol, device="cpu")


def _single_result(problem, plan):
    """The request solved alone under the batch's plan."""
    return execute(problem, dataclasses.replace(plan, batch=1))


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_mixed_specs_and_operators_never_cross_batches(poisson):
    data, cols = poisson
    svc = SolverService(ServiceConfig(max_batch=8))
    problems = {}
    for i in range(4):
        for p in (_stencil("2d5pt", i), _stencil("3d7pt", 10 + i),
                  _cg(data, cols, 20 + i)):
            problems[svc.submit(p)] = p
    assert svc.pending() == 12
    results = svc.drain()
    stats = svc.stats()
    assert svc.pending() == 0
    assert stats["served"] == 12 and stats["batches"] == 3
    assert stats["mean_batch_size"] == 4.0
    assert len(svc.chosen_plans()) == 3
    for rid, problem in problems.items():
        rr = results[rid]
        assert isinstance(rr, RequestResult) and rr.batch_size == 4
        _same(rr.result, _single_result(problem, rr.plan))


def test_different_cg_operators_do_not_share_a_batch(poisson):
    data, cols = poisson
    svc = SolverService(ServiceConfig(max_batch=8))
    svc.submit(_cg(data, cols, 0))
    svc.submit(_cg(data.clone(), cols, 1))
    svc.drain()
    assert svc.stats()["batches"] == 2


def test_padding_to_planned_width():
    svc = SolverService(ServiceConfig(max_batch=4, pad_to_max=True))
    problems = {svc.submit(_stencil("2d5pt", i)): i for i in range(3)}
    results = svc.drain()
    assert set(results) == set(problems)
    for rr in results.values():
        assert rr.batch_size == 3 and rr.padded_to == 4
        assert rr.plan.batch == 4
    assert svc.stats()["pad_fraction"] == pytest.approx(1 / 4)


def test_no_padding_mode_plans_actual_width():
    svc = SolverService(ServiceConfig(max_batch=4, pad_to_max=False))
    for i in range(3):
        svc.submit(_stencil("2d5pt", i))
    for rr in svc.drain().values():
        assert rr.batch_size == 3 and rr.padded_to == 3


def test_fifo_oldest_key_group_first():
    svc = SolverService(ServiceConfig(max_batch=8))
    a0 = svc.submit(_stencil("2d5pt", 0))
    b0 = svc.submit(_stencil("3d7pt", 1))
    a1 = svc.submit(_stencil("2d5pt", 2))
    assert set(svc.run_batch()) == {a0, a1}
    assert set(svc.run_batch()) == {b0}


def test_max_batch_splits_oversized_groups():
    svc = SolverService(ServiceConfig(max_batch=2))
    ids = [svc.submit(_stencil("2d5pt", i)) for i in range(5)]
    assert set(svc.run_batch()) == set(ids[:2])
    svc.drain()
    assert svc.stats()["batches"] == 3


def test_service_rejects_prebatched_submissions():
    svc = SolverService()
    assert svc.cfg.chip == "h100"
    bp = BatchedProblem.from_instances([_stencil("2d5pt", 0)])
    with pytest.raises(TypeError, match="single-instance"):
        svc.submit(bp)
    with pytest.raises(ValueError, match="no queued"):
        svc.run_batch()


def test_plan_is_cached_per_key_and_telemetry_accumulates():
    svc = SolverService(ServiceConfig(max_batch=2))
    for i in range(4):
        svc.submit(_stencil("2d5pt", i))
    results = svc.drain()
    stats = svc.stats()
    assert stats["batches"] == 2 and stats["distinct_plans"] == 1
    assert stats["instances_per_s"] > 0
    assert stats["mean_latency_s"] >= stats["mean_queued_s"] >= 0
    assert len({id(rr.plan) for rr in results.values()}) == 1


@pytest.mark.parametrize("top_k", [0, 3])
def test_service_respects_convergence_checks(top_k):
    """A request that declares tol gets a plan that can evaluate it, with
    and without autotuning, and stops early."""
    ell = poisson2d(16).to_ell()
    data, cols = torch.from_numpy(ell.data), torch.from_numpy(ell.cols)
    svc = SolverService(ServiceConfig(max_batch=2, autotune_top_k=top_k))
    probs = [_cg(data, cols, 40 + i, iters=500, tol=1e-10)
             for i in range(2)]
    rids = [svc.submit(p) for p in probs]
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        results = svc.drain()
    for rid, p in zip(rids, probs):
        assert honors_on_sync(results[rid].plan, 500)
        _, rr = results[rid].result
        assert float(rr) < 1e-10 * float(torch.dot(p.b, p.b)) * 10


def test_loop_tier_runner_is_reused_across_batches():
    """One runner per key: later batches of the key (new payloads) run
    through the first batch's runner, so its device loop's kept graph, bit
    for bit against each instance alone."""
    svc = SolverService(ServiceConfig(max_batch=2))
    first = [_stencil("2d5pt", i) for i in range(2)]
    later = [_stencil("2d5pt", 10 + i) for i in range(2)]
    bp = BatchedProblem.from_instances(first)
    reg = obs.MetricsRegistry()
    with obs.use_metrics(reg):
        runner = svc._make_runner(bp, Plan(tier="device_loop", batch=2))
    for batch_insts in (first, later):
        batch = BatchedProblem.from_instances(batch_insts)
        with obs.use_metrics(reg):
            out = runner(batch)
        seq = execute_sequential(batch_insts, Plan(tier="device_loop"))
        for got, want in zip(batch.split(out), seq):
            assert torch.equal(got, want)
    assert reg.value("executor_retraces_total", tier="device_loop") == 1
    assert reg.value("executor_executions_total", tier="device_loop") == 2
    # resident plans and convergence-checked batches have no kept runner
    assert svc._make_runner(
        bp, Plan(tier="resident", batch=2, cached_rows=8)) is None
    data = torch.from_numpy(load_matrix("poisson_64").to_ell().data)
    cols = torch.from_numpy(load_matrix("poisson_64").to_ell().cols)
    tol_bp = BatchedProblem.from_instances(
        [_cg(data, cols, i, iters=8, tol=1e-8) for i in range(2)])
    assert svc._make_runner(
        tol_bp, Plan(tier="device_loop", batch=2, sync_every=4)) is None


def test_service_runs_every_batch_of_a_key_through_one_runner():
    svc = SolverService(ServiceConfig(max_batch=2))
    reg = obs.MetricsRegistry()
    probs = {svc.submit(_stencil("2d5pt", i)): i for i in range(6)}
    with obs.use_metrics(reg):
        results = svc.drain()
    (plan_, template, runner), = svc._plans.values()
    assert plan_.tier in ("host_loop", "device_loop") and runner is not None
    assert reg.value("executor_retraces_total", tier=plan_.tier) == 1
    assert reg.value("executor_executions_total", tier=plan_.tier) == 3
    for rid, i in probs.items():
        _same(results[rid].result, _single_result(_stencil("2d5pt", i),
                                                  plan_))
    text = svc.metrics.prometheus_text()
    assert "service_served_total 6" in text
    assert 'service_graph_captures_total{problem="stencil_2d5pt"} 0' in text


def test_autotuned_service_still_correct():
    svc = SolverService(ServiceConfig(max_batch=2, autotune_top_k=2))
    problems = {svc.submit(_stencil("2d5pt", i)): i for i in range(2)}
    results = svc.drain()
    assert set(results) == set(problems)
    for rid, i in problems.items():
        assert results[rid].plan.batch == 2
        _same(results[rid].result, _single_result(_stencil("2d5pt", i),
                                                  results[rid].plan))


def test_cold_vs_warm_key_plan_time_is_separated():
    ticks = itertools.count()
    svc = SolverService(ServiceConfig(max_batch=2),
                        clock=lambda: float(next(ticks)))
    cold = [svc.submit(_stencil("2d5pt", i)) for i in range(2)]
    warm = [svc.submit(_stencil("2d5pt", 10 + i)) for i in range(2)]
    results = svc.drain()
    for rid in cold:
        rr = results[rid]
        assert rr.plan_s > 0.0
        assert rr.latency_s >= rr.queued_s + rr.plan_s + rr.exec_s
    for rid in warm:
        assert results[rid].plan_s == 0.0 and results[rid].queued_s >= 0.0
    assert svc.stats()["plan_s_total"] == results[cold[0]].plan_s


def test_plan_cache_pins_operator_objects(poisson):
    data, cols = poisson
    svc = SolverService(ServiceConfig(max_batch=2))
    svc.submit(_cg(data, cols, 0))
    svc.drain()
    (_, template, _), = svc._plans.values()
    assert template.data is data
    assert svc.evict_plans() == 1
    assert svc.stats()["distinct_plans"] == 0


def test_stats_cover_the_core_keys(poisson):
    data, cols = poisson
    ticks = itertools.count()
    svc = SolverService(ServiceConfig(max_batch=2),
                        clock=lambda: float(next(ticks)))
    for i in range(2):
        svc.submit(_cg(data, cols, i, iters=40, tol=1e-8))
    svc.drain()
    stats = svc.stats()
    assert CORE_STATS_KEYS <= set(stats)
    assert stats["served"] == 2 == svc.metrics.value("service_served_total")
    snap = svc.metrics.snapshot()
    assert snap["service_latency_s_count"] == 2
    assert stats["p99_latency_s"] == snap["service_latency_s_p99"]


def test_same_size_different_matrix_never_shares_runner():
    ops_ = []
    for seed in (31, 32):
        ell = banded_spd(512, 4, seed=seed).to_ell()
        ops_.append((torch.from_numpy(ell.data), torch.from_numpy(ell.cols)))
    b = np.random.default_rng(5).standard_normal(512).astype(np.float32)
    p1, p2 = (CGProblem.from_ell(d, c, b, STEPS, device="cpu")
              for d, c in ops_)
    assert p1.name != p2.name and p1.batch_key() != p2.batch_key()
    svc = SolverService(ServiceConfig(max_batch=8))
    rids = {svc.submit(p): p for p in (p1, p2)}
    results = svc.drain()
    assert svc.stats()["batches"] == 2 and len(svc.chosen_plans()) == 2
    for rid, prob in rids.items():
        _same(results[rid].result, _single_result(prob, results[rid].plan))
    xs = [results[r].result[0] for r in rids]
    assert float((xs[0] - xs[1]).abs().max()) > 1e-3
