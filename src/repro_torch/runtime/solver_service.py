"""Multi-tenant solver serving: queue -> pack -> one persistent dispatch —
the synchronous ``SolverService`` of ``repro/runtime/solver_service.py``.

Users submit iterative problems (any :class:`~repro_torch.exec.problem.Problem`
with a batched step: stencils, CG on ELL planes); the service packs
shape-compatible requests into :class:`~repro_torch.exec.batch.BatchedProblem`
batches, plans them under the B-scaled working set (``plan_candidates``
of the batch), runs each batch through ONE dispatch a step (or a step
chunk) and hands every request its own result with queueing, latency and
execution times.

Packing policy:

* requests are grouped by :meth:`Problem.batch_key` (family, shapes,
  dtypes, shared operands, step count); two requests with different keys
  never share a batch;
* within a group, strict FIFO; across groups, the group owning the oldest
  pending request is served first (no starvation);
* a batch is padded up to ``max_batch`` by replicating its last instance
  (``pad_to_max``), so every dispatch of a key has the same shapes: the
  service builds each key's loop-tier runner once (``_make_runner``) and
  reuses it, so a key's device loop captures its CUDA graph on its first
  batch and replays it for every later one. Padded lanes are dropped
  before results are returned.

``exec_s`` and ``latency_s`` wait for the card before the clock stops.
Batches have fixed membership: a late arrival waits out the running
batch, and a convergence-checked batch runs until its slowest instance
converges. The continuous-batching ``AsyncSolverService`` is not ported
yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch import obs
from repro_torch.core import perks
from repro_torch.exec.batch import BatchedProblem
from repro_torch.exec.executor import (_record_plan_metrics, execute,
                                      honors_on_sync, wait)
from repro_torch.exec.plan import Plan
from repro_torch.exec.planner import _candidates
from repro_torch.exec.problem import Problem

#: The stats() keys every service guarantees, with the reference's
#: meaning: the schema a dashboard can rely on whichever engine serves.
#: Keys beyond this set are engine-specific.
CORE_STATS_KEYS = frozenset({
    "served", "instances_per_s", "plan_s_total",
    "mean_queued_s", "p50_queued_s", "p99_queued_s",
    "mean_latency_s", "p50_latency_s", "p99_latency_s",
    "mean_exec_s", "p50_exec_s", "p99_exec_s",
})


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Serving knobs.

    ``max_batch`` is the dispatch width B the planner prices; with
    ``pad_to_max`` every batch is padded to exactly B instances so each
    batch key owns one set of shapes (one kept CUDA graph). ``chip`` feeds the planner;
    ``autotune_top_k`` > 0 measures the top-k candidates per key instead
    of trusting the projection (one-off cost per key, amortized across
    every later batch of that key).
    """

    max_batch: int = 8
    pad_to_max: bool = True
    chip: Any = "h100"
    autotune_top_k: int = 0


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """One served request: its result plus the service-level telemetry."""

    request_id: int
    result: Any
    queued_s: float          # submit -> picked off the queue (PURE queue time)
    latency_s: float         # submit -> result ready
    exec_s: float            # wall time of the dispatch(es) it rode in,
    #                          waited for on the card
    batch_size: int          # real instances in that dispatch (pre-padding)
    padded_to: int           # dispatch width after padding
    plan: Plan               # the Plan the batch executed under
    plan_s: float = 0.0      # planning/autotune time this request waited on
    #                          (exactly 0.0 on a warm key — cold-key cost is
    #                          never smeared into queued_s)
    steps: Optional[int] = None  # steps executed for this request (None:
    #                          not tracked per lane)


@dataclasses.dataclass
class _Pending:
    request_id: int
    problem: Problem
    submitted_s: float


class SolverService:
    """Queue solver requests, serve them in planned batches.

    >>> svc = SolverService(ServiceConfig(max_batch=8))
    >>> rid = svc.submit(StencilProblem(x, spec, steps))
    >>> results = svc.drain()          # {request_id: RequestResult}
    """

    def __init__(self, cfg: ServiceConfig = ServiceConfig(), *, mesh=None,
                 clock=time.perf_counter, metrics=None, tracer=None):
        self.cfg = cfg
        self.mesh = mesh
        self._clock = clock
        self._queue: list[_Pending] = []
        self._next_id = 0
        # batch_key -> (chosen Plan, template problem pinning operand ids,
        # steady-state runner or None); see _make_runner
        self._plans: dict[tuple, tuple[Plan, Problem, Optional[Callable]]] = {}
        # every service counter lives in a MetricsRegistry and stats() is a
        # thin view over it. The default is a PRIVATE
        # registry, not the ambient one, so two services never alias each
        # other's counters; pass a shared registry to aggregate across
        # services or export through one Prometheus endpoint.
        self.metrics = metrics if metrics is not None else obs.MetricsRegistry()
        self._tracer = tracer

    def _tr(self):
        return self._tracer if self._tracer is not None else obs.get_tracer()

    # -- intake ---------------------------------------------------------------

    def submit(self, problem: Problem) -> int:
        """Enqueue one problem instance; returns its request id."""
        if isinstance(problem, BatchedProblem):
            raise TypeError("submit single-instance problems; the service "
                            "owns the batching")
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Pending(rid, problem, self._clock()))
        return rid

    def pending(self) -> int:
        return len(self._queue)

    # -- packing --------------------------------------------------------------

    def _take_batch(self) -> list[_Pending]:
        """Up to ``max_batch`` requests sharing the OLDEST request's batch
        key, FIFO order; everything else stays queued. Never mixes keys."""
        if not self._queue:
            raise ValueError("no queued requests")
        key = self._queue[0].problem.batch_key()
        taken, kept = [], []
        for p in self._queue:
            if len(taken) < self.cfg.max_batch and \
                    p.problem.batch_key() == key:
                taken.append(p)
            else:
                kept.append(p)
        self._queue = kept
        return taken

    def _make_runner(self, bp: BatchedProblem,
                     chosen: Plan) -> Optional[Callable]:
        """ONE runner per batch key for the loop tiers.

        ``execute()`` builds a runner over the batch's own step function
        on every call, and the device loop keeps its CUDA graph per step
        function, so each batch would capture its own. Padding gives every
        dispatch of a key the same shapes, and the shared operands inside
        the step are the same objects by batch-key construction, so the
        service builds the runner once, over the first batch's step
        function, and runs every later batch of the key through it: the
        key's graph is captured once and replayed. Problems with an
        ``on_sync`` callback rebuild a batch (the callback closes over
        per-instance thresholds; their chunked device loop keeps no
        graph), and the resident tier is one launch with nothing to
        keep.
        """
        if chosen.tier not in ("host_loop", "device_loop"):
            return None
        if bp.on_sync() is not None:
            return None
        execution = (perks.Execution.HOST_LOOP
                     if chosen.tier == "host_loop"
                     else perks.Execution.DEVICE_LOOP)
        cfg = perks.PerksConfig(execution=execution,
                                sync_every=chosen.sync_every,
                                fuse_steps=chosen.fuse_steps)
        runner = perks.persistent(bp.step_fn(), bp.n_steps, cfg)
        obs.get_metrics().counter("executor_retraces_total",
                                  tier=chosen.tier).inc()

        def run(batch):
            _record_plan_metrics(chosen)
            return batch.finalize(runner(batch.initial_state()))

        return run

    def _plan_for(self, bp: BatchedProblem) -> tuple[Plan, Optional[Callable],
                                                     float]:
        """The key's plan and steady-state runner, and the planning seconds
        spent on THIS call, measured inside the plan cache: a warm key
        reports exactly 0.0, and a cold key's planning and autotuning are
        reported as ``plan_s``, never folded into ``queued_s``."""
        key = bp.batch_key()
        cached = self._plans.get(key)
        if cached is None:
            t_plan = self._clock()
            # the key's runner keeps its device loop's graph for every
            # later batch (_make_runner): price the replay
            cands = _candidates(bp, chip=self.cfg.chip, graph_kept=True)
            # a service must honor a request's convergence contract: only
            # candidates that can actually evaluate a declared on_sync
            # check may be chosen (projection-ranked AND autotuned paths),
            # never a marginally-faster plan that silently runs every step
            if bp.on_sync() is not None:
                honoring = [c for c in cands
                            if honors_on_sync(c, bp.n_steps)]
                cands = honoring or cands
            if self.cfg.autotune_top_k > 0:
                from repro_torch.exec.executor import autotune
                chosen = autotune(bp, cands, mesh=self.mesh,
                                  top_k=self.cfg.autotune_top_k).best
            else:
                chosen = cands[0]
            # the template rides along to pin the batch key's operand
            # objects alive: id()s in the key can never be recycled while
            # the plan cache maps them (one entry per operator ever
            # served — bound it with evict_plans() if operators churn)
            cached = (chosen, bp.template, self._make_runner(bp, chosen))
            self._plans[key] = cached
            plan_s = self._clock() - t_plan
            self.metrics.counter("service_plan_s_total").inc(plan_s)
            if chosen.cache:
                streamed = sum(d.total_bytes - d.cached_bytes
                               for d in chosen.cache)
                self.metrics.counter(
                    "service_cache_bytes_cached_total").inc(
                        chosen.cached_bytes)
                self.metrics.counter(
                    "service_cache_bytes_streamed_total").inc(streamed)
            return cached[0], cached[2], plan_s
        return cached[0], cached[2], 0.0

    # -- serving --------------------------------------------------------------

    def run_batch(self) -> dict[int, RequestResult]:
        """Serve one batch (the oldest key group) and return its results."""
        taken = self._take_batch()
        t_q = self._clock()   # queue time ends when the batch is picked up
        pad_to = self.cfg.max_batch if self.cfg.pad_to_max else None
        bp = BatchedProblem.from_instances([p.problem for p in taken],
                                           pad_to=pad_to)
        chosen, runner, plan_s = self._plan_for(bp)
        tr = self._tr()
        span = (tr.span(f"serve_batch:{bp.name}", cat="dispatch",
                        track="service", tier=chosen.tier,
                        batch_size=len(taken), padded_to=bp.batch)
                if tr.enabled else None)
        if span is not None:
            span.__enter__()
        captures = perks.capture.count
        t0 = self._clock()
        if runner is not None:
            result = runner(bp)
        else:
            result = execute(bp, chosen, mesh=self.mesh)
        wait(result)
        t1 = self._clock()
        if span is not None:
            span.__exit__(None, None, None)
        self.metrics.counter(
            "service_graph_captures_total",
            problem=bp.template.name).inc(perks.capture.count - captures)
        per_request = bp.split(result)

        mx = self.metrics
        out: dict[int, RequestResult] = {}
        for pend, res in zip(taken, per_request):
            rr = RequestResult(
                request_id=pend.request_id, result=res,
                queued_s=t_q - pend.submitted_s,
                latency_s=t1 - pend.submitted_s,
                exec_s=t1 - t0, batch_size=len(taken), padded_to=bp.batch,
                plan=chosen, plan_s=plan_s)
            out[pend.request_id] = rr
            mx.histogram("service_queued_s").observe(rr.queued_s)
            mx.histogram("service_latency_s").observe(rr.latency_s)
            mx.histogram("service_exec_s").observe(rr.exec_s)
        mx.counter("service_served_total").inc(len(taken))
        mx.counter("service_batches_total").inc()
        mx.counter("service_padded_lanes_total").inc(bp.pad)
        mx.counter("service_exec_s_total").inc(t1 - t0)
        return out

    def drain(self) -> dict[int, RequestResult]:
        """Serve the whole queue, batch by batch."""
        out: dict[int, RequestResult] = {}
        while self._queue:
            out.update(self.run_batch())
        return out

    # -- telemetry ------------------------------------------------------------

    def stats(self) -> dict[str, float]:
        """A thin view over :attr:`metrics`: every number here is a
        registry metric (or a ratio of two). Guarantees
        :data:`CORE_STATS_KEYS`; the extra keys are engine-specific."""
        mx = self.metrics
        served = mx.value("service_served_total")
        batches = mx.value("service_batches_total")
        padded = mx.value("service_padded_lanes_total")
        exec_s_total = mx.value("service_exec_s_total")
        out = {
            "served": served,
            "batches": batches,
            "mean_batch_size": served / max(1, batches),
            "pad_fraction": padded / max(1, served + padded),
            "exec_s_total": exec_s_total,
            "plan_s_total": mx.value("service_plan_s_total"),
            "instances_per_s": served / max(1e-9, exec_s_total),
            "distinct_plans": len(self._plans),
        }
        for name in ("queued", "latency", "exec"):
            h = mx.histogram(f"service_{name}_s")
            out[f"mean_{name}_s"] = h.mean
            out[f"p50_{name}_s"] = h.percentile(0.50)
            out[f"p99_{name}_s"] = h.percentile(0.99)
        return out

    def chosen_plans(self) -> dict[tuple, Plan]:
        """The Plan each batch key executed under (loggable artifacts)."""
        return {k: entry[0] for k, entry in self._plans.items()}

    def evict_plans(self) -> int:
        """Drop every cached plan (and the operand pins that ride along).

        Long-lived services whose operators churn call this periodically:
        the plan cache pins each key's operand objects alive so that the
        ``id()``\\ s inside batch keys can never be recycled into a
        collision, which also means it grows by one entry per operator
        ever served until evicted. Returns the number of entries dropped.
        """
        n = len(self._plans)
        self._plans.clear()
        return n
