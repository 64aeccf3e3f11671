"""``execute(problem, plan)`` — the single dispatch path over the
single-device tiers — and ``autotune``, which measures the planner's top
candidates on the card and returns the empirical winner with its timing
table: the port of ``repro/exec/executor.py``.

The executor owns only orchestration: the loop combinators
(``core.perks``) for the host and device loops and the problem's own hook
for the resident tier. The ambient observability context
(``repro_torch.obs``) sees every call: executor counters always; the
``execute:`` span, ``cache:`` events and a loop tier's chunk and barrier
events when a real tracer is installed (host time, never a wait for the
card); and a predicted-against-measured row in the drift ledger when one
is active, whose measurement waits for the card before its clock stops.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core import perks
from repro_torch.exec import planner as _planner
from repro_torch.exec.plan import Plan
from repro_torch.exec.problem import Problem, _leaves


def _record_plan_metrics(plan: Plan) -> None:
    """Executor-level counters the service layer cannot see: executions,
    barriers, fused steps per pass, bytes resident against streamed per
    CacheDecision. Derived from the Plan: the executed program's
    structure is the plan's structure."""
    mx = obs.get_metrics()
    mx.counter("executor_executions_total", tier=plan.tier).inc()
    mx.counter("executor_barriers_total", tier=plan.tier).inc(plan.barriers)
    mx.gauge("executor_fused_steps_per_pass", tier=plan.tier).set(
        plan.fuse_steps)
    if plan.cache:
        streamed = sum(d.total_bytes - d.cached_bytes for d in plan.cache)
        mx.counter("executor_cache_decisions_total").inc(len(plan.cache))
        mx.counter("executor_bytes_cached_total").inc(plan.cached_bytes)
        mx.counter("executor_bytes_streamed_total").inc(streamed)


def _traced_on_sync(tracer, on_sync, track: str, problem_name: str):
    """Wrap (or stand in for) a problem's ``on_sync`` so every host-sync
    barrier of a loop-tier run lands in the trace as a chunk and a barrier
    event. Host-side bookkeeping only: the callback's verdict is returned
    unchanged (False where there was none), so a traced run computes the
    bits of an untraced one."""

    def synced(state, k):
        tracer.event("chunk", cat="chunk", track=track,
                     problem=problem_name, steps_done=k)
        stop = False if on_sync is None else bool(on_sync(state, k))
        tracer.event("barrier", cat="barrier", track=track,
                     problem=problem_name, steps_done=k, stop=stop)
        return stop

    return synced


def wait(result=None) -> None:
    """Wait for the card to finish the work behind ``result`` (the
    reference's ``block_until_ready``), or for all its work when no
    result is given; a no-op on the CPU."""
    if result is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    for t in _leaves(result):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


def execute(problem: Problem, plan: Plan, *, mesh=None):
    """Run ``problem`` under ``plan``; returns the problem's final result.

    The loop tiers run the problem's step function through the
    ``core.perks`` combinators; the resident tier is the problem's own
    hook. The distributed tier is not ported and raises. With a drift
    ledger active (``obs.use_ledger``) the call waits for the card and
    records its wall time; values are unchanged.
    """
    if plan.n_steps and plan.n_steps != problem.n_steps:
        raise ValueError(
            f"plan.n_steps={plan.n_steps} != problem.n_steps="
            f"{problem.n_steps}; plans are per-problem-instance")
    if plan.batch != problem.batch:
        raise ValueError(
            f"plan.batch={plan.batch} != problem.batch={problem.batch}; a "
            f"batched plan must run the BatchedProblem it was made for "
            f"(repro_torch.exec.batch)")
    if not problem.supports(plan.tier):
        why = getattr(problem, "unsupported", None)
        raise NotImplementedError(
            why(plan.tier) if why is not None else
            f"{type(problem).__name__} does not support tier {plan.tier!r}")
    if plan.precision != "uniform":
        problem = problem.with_precision(plan.precision)
    on_sync = problem.on_sync()
    if on_sync is not None and not honors_on_sync(plan, problem.n_steps):
        warnings.warn(
            f"{problem.name} declares a convergence check but the "
            f"{plan.tier} plan has no host-sync points (sync_every="
            f"{plan.sync_every}); running all {problem.n_steps} steps",
            RuntimeWarning, stacklevel=2)
    if plan.tier == "distributed" and mesh is None:
        raise ValueError("distributed plan needs mesh=")
    tr = obs.get_tracer()
    ledger = obs.get_ledger()
    _record_plan_metrics(plan)
    track = f"tier:{plan.tier}"
    if tr.enabled:
        for d in plan.cache:
            tr.event(f"cache:{d.name}", cat="cache", track=track,
                     problem=problem.name, cached_bytes=d.cached_bytes,
                     total_bytes=d.total_bytes, fraction=d.fraction)
    span = (tr.span(f"execute:{problem.name}", cat="dispatch", track=track,
                    tier=plan.tier, fuse_steps=plan.fuse_steps,
                    batch=plan.batch, n_steps=problem.n_steps,
                    barriers=plan.barriers) if tr.enabled
            else _noop_span)
    if ledger is not None:
        wait()                            # earlier work is not this call's
    t0 = time.perf_counter() if ledger is not None else 0.0
    with span:
        result = _dispatch(problem, plan, mesh, on_sync, tr, track)
        if ledger is not None:
            wait(result)
    if ledger is not None:
        ledger.record(problem, plan, time.perf_counter() - t0)
    return result


class _NoopSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_noop_span = _NoopSpan()


def _dispatch(problem: Problem, plan: Plan, mesh, on_sync, tracer, track):
    """The tier dispatch proper (validation and observability live in
    ``execute``)."""
    if plan.tier == "distributed":
        return problem.run_distributed(plan, mesh)
    if plan.tier == "resident":
        return problem.run_resident(plan)
    execution = (perks.Execution.HOST_LOOP if plan.tier == "host_loop"
                 else perks.Execution.DEVICE_LOOP)
    cfg = perks.PerksConfig(execution=execution, sync_every=plan.sync_every,
                            fuse_steps=plan.fuse_steps)
    if tracer.enabled and honors_on_sync(plan, problem.n_steps):
        on_sync = _traced_on_sync(tracer, on_sync, track, problem.name)
    runner = perks.persistent(problem.step_fn(), problem.n_steps, cfg,
                              on_sync=on_sync)
    obs.get_metrics().counter("executor_retraces_total",
                              tier=plan.tier).inc()
    return problem.finalize(runner(problem.initial_state()))


def honors_on_sync(plan: Plan, n_steps: int) -> bool:
    """Whether this plan's execution path ever calls the problem's
    ``on_sync``: HOST_LOOP always (it is back on the host after every
    dispatch), DEVICE_LOOP only when sync_every < n, the resident kernels
    and distributed programs never."""
    if plan.tier == "host_loop":
        return True
    if plan.tier == "device_loop":
        return plan.sync_every is not None and plan.sync_every < n_steps
    return False


@dataclasses.dataclass(frozen=True)
class TimingRow:
    """One autotune measurement: the plan, its planner prediction, and the
    measured wall-clock seconds (median over ``iters`` timed calls, each
    waited for on the card)."""

    plan: Plan
    predicted_s: Optional[float]
    measured_s: float

    @property
    def prediction_ratio(self) -> Optional[float]:
        """measured / predicted: how far off the model was. None only where
        there is no prediction; a predicted 0.0 reports ``inf``."""
        if self.predicted_s is None:
            return None
        if self.predicted_s == 0.0:
            return math.inf if self.measured_s > 0.0 else 1.0
        return self.measured_s / self.predicted_s


@dataclasses.dataclass(frozen=True)
class AutotuneResult:
    best: Plan
    table: tuple[TimingRow, ...]   # planner order (rank 0 = predicted best)

    def row_for(self, plan: Plan) -> TimingRow:
        for r in self.table:
            if r.plan == plan:
                return r
        raise KeyError("plan not in autotune table")


def _time_once(fn, warmup: int, iters: int) -> float:
    """Median wall seconds of ``fn`` over ``iters`` calls after ``warmup``
    calls, each call waited for on the card before its clock stops."""
    for _ in range(warmup):
        wait(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        wait(fn())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def autotune(problem: Problem, candidates: Optional[Sequence[Plan]] = None,
             *, chip=None, mesh=None, top_k: int = 4, warmup: int = 1,
             iters: int = 3, ledger=None, **plan_kw) -> AutotuneResult:
    """Measure the top-``top_k`` planner candidates and return the winner.

    ``candidates`` defaults to ``plan_candidates(problem, ...)``
    (distributed plans are dropped unless ``mesh`` is given). The result's
    ``table`` keeps the planner's predicted order, so a caller can report
    predicted against measured for each candidate; ``best`` is the
    measured winner.

    ``ledger`` (default: the ambient ``repro_torch.obs.get_ledger()``) is
    the persisted drift ledger: a candidate it has already timed on this
    device with this torch and CUDA is not measured again (its stored
    ``measured_s`` fills the row; ``ledger.hits`` counts the skips), and
    every fresh measurement and the winner are written back.
    """
    if candidates is None:
        kw = dict(plan_kw)
        if chip is not None:
            kw["chip"] = chip
        candidates = _planner.plan_candidates(problem, **kw)
    if ledger is None:
        ledger = obs.get_ledger()
    tr = obs.get_tracer()
    runnable = [p for p in candidates
                if p.tier != "distributed" or mesh is not None]
    if not runnable:
        raise ValueError("no runnable candidates for this problem/host")
    rows = []
    for p in runnable[:max(1, top_k)]:
        rec = ledger.lookup(problem, p) if ledger is not None else None
        if rec is not None:
            measured = rec.measured_s
        else:
            # time without the ambient ledger: its per-call rows would
            # stand in for this measurement
            with obs.use_ledger(None):
                measured = _time_once(
                    lambda: execute(problem, p, mesh=mesh), warmup, iters)
            if ledger is not None:
                ledger.record(problem, p, measured)
        row = TimingRow(p, p.predicted_s, measured)
        if tr.enabled:
            tr.event("autotune_measure", cat="measure", track="autotune",
                     problem=problem.name, plan=obs.plan_signature(p),
                     predicted_s=p.predicted_s, measured_s=measured,
                     from_ledger=rec is not None)
        rows.append(row)
    best = min(rows, key=lambda r: r.measured_s).plan
    if ledger is not None:
        ledger.set_best(problem, best)
    return AutotuneResult(best=best, table=tuple(rows))
