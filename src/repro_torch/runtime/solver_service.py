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
:class:`SolverService` batches have fixed membership: a late arrival waits
out the running batch, and a convergence-checked batch runs until its
slowest instance converges. :class:`AsyncSolverService` (bottom of this
module) removes both limits with continuous batching: each batch key owns
a persistent :class:`~repro_torch.exec.batch.LaneRunner` lane group driven
by an open-ended ``core.perks.chunked_loop`` whose chunk is one kept CUDA
graph; at every barrier the scheduler retires individually converged
lanes (one stacked convergence read, one host transfer) and admits
waiting same-key requests into the freed lanes mid-solve, writing them
into the tensors the graph reads. Admission is a bounded queue with a
``reject``/``shed`` overload policy and an optional queue-wait SLA.
Batching covers the stencil, CG, BiCGStab and GMRES problems (the Krylov
ones on ELL planes); the ML problems have no batched step yet (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch import obs
from repro_torch.core import perks
from repro_torch.exec.batch import BatchedProblem, LaneRunner, LaneState
from repro_torch.exec.executor import (_record_plan_metrics, execute,
                                      honors_on_sync, wait)
from repro_torch.exec.plan import Plan
from repro_torch.exec.planner import _candidates, plan_candidates
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


# -----------------------------------------------------------------------------
# Continuous-batching async engine
# -----------------------------------------------------------------------------

class ServiceOverloaded(RuntimeError):
    """Raised by :meth:`AsyncSolverService.submit` when the bounded queue
    is full and the overload policy is ``"reject"``."""


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs of the continuous-batching engine.

    ``max_batch`` is the lane-group width (the width every key's lane
    program is built for). ``chunk_steps`` overrides the steps run between
    barriers (default: the chosen plan's ``sync_every``, else
    ``ceil(n_steps / 4)``, so every request sees a few admission and
    retirement points). ``max_queue`` bounds the waiting queue
    (backpressure); on overflow the ``overload`` policy either rejects the
    NEW submission (:class:`ServiceOverloaded`) or sheds the OLDEST waiting
    request (the one least likely to still meet its SLA). ``sla_queued_s``
    is the queue-wait SLA: under ``"shed"`` a request whose wait already
    exceeds it is dropped at admission instead of taking a lane; under
    ``"reject"`` it is still served but counted in ``sla_misses``.
    ``chip`` feeds the planner.
    """

    max_batch: int = 8
    chunk_steps: Optional[int] = None
    max_queue: int = 1024
    overload: str = "reject"            # "reject" | "shed"
    sla_queued_s: Optional[float] = None
    chip: Any = "h100"

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.overload not in ("reject", "shed"):
            raise ValueError(
                f"overload must be 'reject' or 'shed', got {self.overload!r}")


@dataclasses.dataclass
class _Program:
    """One batch key's lane program, built once and reused by every group
    activation of the key: its runner, the lane group's tensors (all lanes
    free between activations) and the open-ended drive whose kept chunk
    graph reads and writes those tensors."""

    template: Problem
    plan: Plan
    chunk: int
    runner: LaneRunner
    lanes: LaneState
    drive: Callable          # open-ended chunked_loop over the group step
    plan_s: float            # planning cost, charged to the cold activation


@dataclasses.dataclass
class _Lane:
    """Host-side mirror of one device lane."""

    pending: Optional[_Pending] = None   # None = free
    steps: int = 0                       # host mirror of steps_done[lane]
    admitted_s: float = 0.0
    plan_s: float = 0.0


@dataclasses.dataclass
class _Group:
    """The active lane group: one key's lanes currently being driven."""

    key: tuple
    prog: _Program
    slots: list[_Lane]
    plan_s: float            # cold-activation planning cost (0.0 when warm)
    barriers: int = 0


class AsyncSolverService:
    """Continuous-batching solver serving: lanes churn, the graph stays.

    The static :class:`SolverService` is batch-synchronous: it packs a
    batch, runs it to completion, and only then looks at the queue again;
    the slowest instance owns every lane's step count, and a request that
    arrives one step after a dispatch waits out the whole batch. Here each
    batch key owns a lane group of width ``max_batch`` advanced chunk by
    chunk through one kept CUDA graph (an open-ended
    ``core.perks.chunked_loop`` over :class:`~repro_torch.exec.batch.
    LaneRunner`'s masked group step); at every barrier the scheduler

    * waits for the card and reads a per-lane convergence vector (one
      stacked reduction, one host transfer, never one a lane),
    * retires individually converged or exhausted lanes early (their
      result is harvested and the lane masked out),
    * admits newly submitted same-key requests into the freed lanes
      mid-solve, written in place into the tensors the graph reads, so
      nothing is captured anew.

    Requests are admitted under backpressure (bounded queue, reject or
    shed) and every served request carries queued, latency and exec times,
    taken after the card has finished; :meth:`stats` reports p50/p99.
    Every served result is bit for bit its request solved alone under
    ``Plan(tier="device_loop", sync_every=chunk)``.

    ``step()`` advances the engine by exactly one barrier (deterministic:
    the unit tests drive it with a fake clock); ``run_until_idle()`` and
    ``serve(trace)`` drive the open-ended loop until the group drains.

    >>> eng = AsyncSolverService(AsyncConfig(max_batch=8))
    >>> rid = eng.submit(CGProblem.from_ell(data, cols, b, 500, tol=1e-8))
    >>> results = eng.run_until_idle()     # {request_id: RequestResult}
    """

    def __init__(self, cfg: AsyncConfig = AsyncConfig(), *,
                 clock=time.perf_counter, metrics=None, tracer=None):
        self.cfg = cfg
        self._clock = clock
        self._queue: list[_Pending] = []
        self._next_id = 0
        self._programs: dict[tuple, _Program] = {}
        self._group: Optional[_Group] = None
        self._retired_now: dict[int, RequestResult] = {}
        self._quantum: Optional[int] = None   # barriers left in this drive
        self._trace: Optional[list] = None    # (offset_s, problem) replay
        self._trace_i = 0
        self._trace_t0 = 0.0
        # every counter and percentile behind stats() lives in a
        # MetricsRegistry (private by default; see SolverService.__init__)
        self.metrics = metrics if metrics is not None else obs.MetricsRegistry()
        self._tracer = tracer
        self._shed_ids: list[int] = []

    def _tr(self):
        return self._tracer if self._tracer is not None else obs.get_tracer()

    # -- intake ----------------------------------------------------------------

    def submit(self, problem: Problem) -> int:
        """Enqueue one problem under backpressure; returns its request id.

        When the bounded queue is full: ``overload="reject"`` raises
        :class:`ServiceOverloaded` (the caller owns retry and backoff);
        ``overload="shed"`` drops the OLDEST waiting request to make room:
        it has waited longest, so it is the least likely to still meet a
        queue-wait SLA.
        """
        if isinstance(problem, BatchedProblem):
            raise TypeError("submit single-instance problems; the engine "
                            "owns the lane batching")
        if len(self._queue) >= self.cfg.max_queue:
            if self.cfg.overload == "reject":
                self.metrics.counter("async_rejected_total").inc()
                raise ServiceOverloaded(
                    f"queue full ({self.cfg.max_queue} waiting); "
                    f"resubmit after draining or use overload='shed'")
            dropped = self._queue.pop(0)
            self.metrics.counter("async_shed_total").inc()
            self._shed_ids.append(dropped.request_id)
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Pending(rid, problem, self._clock()))
        return rid

    def pending(self) -> int:
        return len(self._queue)

    def shed_ids(self) -> list[int]:
        """Request ids dropped by the shed policy (no result will come)."""
        return list(self._shed_ids)

    # -- planning / program cache ----------------------------------------------

    def _program_for(self, template: Problem) -> _Program:
        key = template.batch_key()
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        t_plan = self._clock()
        width = self.cfg.max_batch
        cands = plan_candidates(template, chip=self.cfg.chip, batch=width)
        # the engine's barriers are device-loop sync points: prefer the
        # best device_loop candidate; any plan is advisory here, the lane
        # group always runs as a chunked device loop so that admission and
        # retirement points exist
        loop = [c for c in cands if c.tier == "device_loop"]
        chosen = (loop or cands)[0]
        n = int(template.n_steps)
        chunk = (self.cfg.chunk_steps or chosen.sync_every
                 or max(1, -(-n // 4)))
        chunk = max(1, min(chunk, n))
        plan = dataclasses.replace(chosen, tier="device_loop",
                                   sync_every=chunk, batch=width)
        runner = LaneRunner(template, width, tracer=self._tracer)
        drive = perks.chunked_loop(runner.step_fn(), None, sync_every=chunk,
                                   on_barrier=self._barrier)
        prog = _Program(template=template, plan=plan, chunk=chunk,
                        runner=runner, lanes=runner.fresh(), drive=drive,
                        plan_s=self._clock() - t_plan)
        self._programs[key] = prog
        self.metrics.counter("async_plan_s_total").inc(prog.plan_s)
        if plan.cache:
            streamed = sum(d.total_bytes - d.cached_bytes
                           for d in plan.cache)
            self.metrics.counter("async_cache_bytes_cached_total").inc(
                plan.cached_bytes)
            self.metrics.counter("async_cache_bytes_streamed_total").inc(
                streamed)
        return prog

    def evict_programs(self) -> int:
        """Drop every cached lane program (its kept graph, its lane
        tensors and its operand pins)."""
        if self._group is not None:
            raise RuntimeError("cannot evict programs while a group is "
                               "active; run_until_idle() first")
        n = len(self._programs)
        for prog in self._programs.values():
            prog.drive.chunk.release()
        self._programs.clear()
        return n

    # -- scheduler --------------------------------------------------------------

    def _activate(self) -> None:
        """Spin up the lane group of the oldest waiting request's key (its
        program's lanes, all free) and admit as many same-key requests as
        fit."""
        template = self._queue[0].problem
        prog = self._program_for(template)
        plan_s, prog.plan_s = prog.plan_s, 0.0   # charge planning once
        g = _Group(key=template.batch_key(), prog=prog,
                   slots=[_Lane() for _ in range(prog.runner.width)],
                   plan_s=plan_s)
        self._group = g
        self.metrics.counter("async_groups_total").inc()
        self._admit_waiting(g)

    def _admit_waiting(self, g: _Group) -> None:
        free = [i for i, s in enumerate(g.slots) if s.pending is None]
        if not free:
            return
        kept = []
        for p in self._queue:
            if free and p.problem.batch_key() == g.key:
                now = self._clock()
                wait_s = now - p.submitted_s
                sla = self.cfg.sla_queued_s
                if sla is not None and wait_s > sla:
                    if self.cfg.overload == "shed":
                        # it already blew its queue-wait SLA: a lane spent
                        # on it is taken from a request that can still meet
                        # its own; drop it here, at admission
                        self.metrics.counter("async_shed_total").inc()
                        self._shed_ids.append(p.request_id)
                        continue
                    self.metrics.counter("async_sla_misses_total").inc()
                lane = free.pop(0)
                slot = g.slots[lane]
                slot.pending = p
                slot.steps = 0
                slot.admitted_s = now
                slot.plan_s = g.plan_s if g.barriers == 0 else 0.0
                g.prog.runner.admit(g.prog.lanes, lane, p.problem)
                if g.barriers > 0:
                    self.metrics.counter(
                        "async_admitted_mid_solve_total").inc()
            else:
                kept.append(p)
        self._queue = kept

    def _retire_lane(self, g: _Group, lane: int, now: float,
                     batch_size: int) -> None:
        slot = g.slots[lane]
        pend = slot.pending
        result = g.prog.runner.harvest(g.prog.lanes, lane)
        wait(result)
        rr = RequestResult(
            request_id=pend.request_id, result=result,
            queued_s=slot.admitted_s - pend.submitted_s,
            latency_s=now - pend.submitted_s,
            exec_s=now - slot.admitted_s,
            batch_size=batch_size, padded_to=g.prog.runner.width,
            plan=g.prog.plan, plan_s=slot.plan_s, steps=slot.steps)
        self._retired_now[pend.request_id] = rr
        mx = self.metrics
        mx.counter("async_served_total").inc()
        if slot.steps < g.prog.runner.n_steps:
            mx.counter("async_retired_early_total").inc()
        mx.histogram("async_queued_s").observe(rr.queued_s)
        mx.histogram("async_latency_s").observe(rr.latency_s)
        mx.histogram("async_exec_s").observe(rr.exec_s)
        slot.pending = None
        g.prog.runner.retire(g.prog.lanes, lane)

    def _barrier(self, carry, done) -> tuple:
        """The scheduler, run at every barrier of the active group: wait
        for the chunk, retire converged and exhausted lanes, admit waiting
        same-key requests into the freed lanes (into the same tensors),
        then decide whether the drive goes on."""
        g = self._group
        g.barriers += 1
        mx = self.metrics
        mx.counter("async_barriers_total").inc()
        self._inject_due_arrivals()
        # a group without a convergence read (stencils) would not wait
        # otherwise: the clock stops once the chunk has run
        wait(g.prog.lanes.steps_done)
        now = self._clock()
        n = g.prog.runner.n_steps
        occupied = [i for i, s in enumerate(g.slots) if s.pending is not None]
        mx.counter("async_occupied_lane_barriers_total").inc(len(occupied))
        tr = self._tr()
        track = f"lanes:{g.prog.template.name}"
        if tr.enabled:
            tr.event("chunk", cat="chunk", track=track, barrier=g.barriers,
                     chunk_steps=g.prog.chunk, occupied=len(occupied))
        conv = g.prog.runner.convergence_vector(g.prog.lanes)
        retired = 0
        for i in occupied:
            slot = g.slots[i]
            slot.steps = min(slot.steps + g.prog.chunk, n)
            if slot.steps >= n or (conv is not None and bool(conv[i])):
                self._retire_lane(g, i, now, batch_size=len(occupied))
                retired += 1
        self._admit_waiting(g)
        drained = not any(s.pending is not None for s in g.slots)
        if tr.enabled:
            tr.event("barrier", cat="barrier", track=track,
                     barrier=g.barriers, retired=retired,
                     waiting=len(self._queue), drained=drained)
        if drained:
            self._group = None               # group drained; program stays
            return carry, True
        if self._quantum is not None:
            self._quantum -= 1
            if self._quantum <= 0:
                return carry, True
        return carry, False

    def _drive(self, quantum: Optional[int]) -> None:
        g = self._group
        prog = g.prog
        self._quantum = quantum
        tr = self._tr()
        span = (tr.span(f"drive:{prog.template.name}", cat="dispatch",
                        track=f"lanes:{prog.template.name}",
                        width=prog.runner.width, chunk=prog.chunk)
                if tr.enabled else None)
        if span is not None:
            span.__enter__()
        t0 = self._clock()
        prog.drive(prog.runner.carry(prog.lanes))
        wait(prog.lanes.steps_done)
        self.metrics.counter("async_busy_s_total").inc(self._clock() - t0)
        if span is not None:
            span.__exit__(None, None, None)

    # -- serving ---------------------------------------------------------------

    def step(self) -> dict[int, RequestResult]:
        """Advance the engine by exactly ONE barrier (activating a group
        first if needed); returns the requests retired at that barrier.
        Deterministic given a deterministic clock: the unit of testing.
        """
        self._retired_now = {}
        if self._group is None:
            if not self._queue:
                return {}
            self._activate()
        self._drive(quantum=1)
        return self._retired_now

    def run_until_idle(self) -> dict[int, RequestResult]:
        """Serve everything currently queued (plus anything admitted while
        serving), group by group, each group's tensors staying in place
        across barriers; returns every request retired during the call."""
        out: dict[int, RequestResult] = {}
        while self._queue or self._group is not None:
            self._retired_now = {}
            if self._group is None:
                self._activate()
            self._drive(quantum=None)        # run until the group drains
            out.update(self._retired_now)
        return out

    def serve(self, trace, *, sleep=time.sleep,
              poll_s: float = 0.001) -> dict[int, RequestResult]:
        """Replay an arrival trace ``[(offset_s, problem), ...]`` against
        the engine: each problem is submitted once the engine's clock
        passes ``offset_s`` (arrivals land mid-solve, at barriers), lane
        groups run continuously while work exists, and the engine sleeps
        only when idle before the next arrival. Returns every served
        request's result; shed and rejected requests are absent (see
        :meth:`shed_ids` and ``stats()['rejected']``).
        """
        out: dict[int, RequestResult] = {}
        self._trace = sorted(trace, key=lambda tp: tp[0])
        self._trace_i = 0
        self._trace_t0 = self._clock()
        try:
            while (self._trace_i < len(self._trace) or self._queue
                   or self._group is not None):
                self._inject_due_arrivals()
                if self._group is None and not self._queue:
                    nxt = (self._trace[self._trace_i][0]
                           - (self._clock() - self._trace_t0))
                    if nxt > 0:
                        sleep(min(nxt, poll_s))
                    continue
                self._retired_now = {}
                if self._group is None:
                    self._activate()
                self._drive(quantum=None)
                out.update(self._retired_now)
        finally:
            self._trace = None
        return out

    def _inject_due_arrivals(self) -> None:
        if self._trace is None:
            return
        now = self._clock() - self._trace_t0
        while (self._trace_i < len(self._trace)
               and self._trace[self._trace_i][0] <= now):
            _, problem = self._trace[self._trace_i]
            self._trace_i += 1
            try:
                self.submit(problem)
            except ServiceOverloaded:
                pass                         # counted in stats()['rejected']

    # -- telemetry -------------------------------------------------------------

    def stats(self) -> dict[str, float]:
        """Engine counters plus p50/p99 queued, latency and exec
        percentiles: a thin view over :attr:`metrics` (nearest-rank
        percentiles of ``obs.Histogram``). Guarantees
        :data:`CORE_STATS_KEYS`."""
        mx = self.metrics
        width = self.cfg.max_batch
        served = mx.value("async_served_total")
        barriers = mx.value("async_barriers_total")
        busy_s = mx.value("async_busy_s_total")
        out = {
            "served": served,
            "groups": mx.value("async_groups_total"),
            "barriers": barriers,
            "admitted_mid_solve": mx.value("async_admitted_mid_solve_total"),
            "retired_early": mx.value("async_retired_early_total"),
            "rejected": mx.value("async_rejected_total"),
            "shed": mx.value("async_shed_total"),
            "sla_misses": mx.value("async_sla_misses_total"),
            "distinct_programs": len(self._programs),
            "lane_occupancy": (mx.value("async_occupied_lane_barriers_total")
                               / max(1, barriers * width)),
            "busy_s": busy_s,
            "plan_s_total": mx.value("async_plan_s_total"),
            "instances_per_s": served / max(1e-9, busy_s),
        }
        for name in ("queued", "latency", "exec"):
            h = mx.histogram(f"async_{name}_s")
            out[f"p50_{name}_s"] = h.percentile(0.50)
            out[f"p99_{name}_s"] = h.percentile(0.99)
            out[f"mean_{name}_s"] = h.mean
        return out

    def graph_captures(self) -> dict[str, int]:
        """CUDA graph captures of each key's chunk over the engine's life
        (by template name): one a key on the card, however many groups and
        admissions it served; 0 on the CPU."""
        return {prog.template.name: prog.drive.chunk.captures
                for prog in self._programs.values()}

    def chosen_plans(self) -> dict[tuple, Plan]:
        return {k: prog.plan for k, prog in self._programs.items()}
