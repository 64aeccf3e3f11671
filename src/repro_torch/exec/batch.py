"""Batched multi-tenant execution: B instances, one persistent dispatch —
the port of ``repro/exec/batch.py``.

PERKS amortizes launch and barrier cost by moving the time loop inside
one dispatch; this module applies the same economics across instances. A
service solving many small stencil or CG problems for concurrent users
should not pay a launch a step per user: it stacks the instances'
payloads and advances all of them through ONE dispatch a step (or a step
chunk).

:class:`BatchedProblem` is that transform inside the
``Problem -> plan -> execute`` pipeline: it wraps B shape-compatible
instances (equal :meth:`Problem.batch_key`) and is itself a
:class:`~repro_torch.exec.problem.Problem`, so ``execute`` and
``autotune`` need no new entry points:

* loop tiers: where the reference's step is ``jax.vmap(step)``, the port's
  is the family's batched step on ``[B, ...]`` tensors
  (``Problem.batched_step_fn``): one ``stencil_step`` launch a step for B
  domains; for B right-hand sides of CG, BiCGStab or GMRES(m) on ELL
  planes one ``spmv_ell`` launch (A read once) an SpMV and one ``vdot``
  launch a dot or a projection on the basis, so a batched step makes the
  single step's launches (``CG_STEP_LAUNCHES``, ``BICGSTAB_STEP_LAUNCHES``,
  ``GMRES_CYCLE_LAUNCHES(m)``). The device loop keeps one CUDA graph for
  the batch's shapes. The ML problems (``SSMScanProblem``,
  ``DecodeAttentionProblem``) and Krylov problems over a matvec callable
  have no batched step yet;
* resident tier: one launch of the family's batched resident kernel
  (``Problem.run_resident_batched``): ``cg_fused`` with B lanes; for
  stencils the kernel the plan names (``stencil_perks``,
  ``stencil_resident``, the shallow tiles or the deep pipelines) with the
  B domains on the grid's y, lane b on ``sms // B`` CTAs laid out as one
  domain on that many (``per_instance_chip``), so at most one lane an SM
  (the reference vmaps any B; waves of lanes are not ported).
  ``bicgstab_fused`` and ``gmres_cycle_fused`` have no batched launch
  yet, so a batch of those families does not support the tier and the
  planner offers none;
* the distributed tier is not ported.

Each lane computes exactly what its instance computes alone on the same
tier: bit for bit against ``execute_sequential`` (asserted over all 13
stencil specs and the sparse registry in ``tests/test_torch_batch.py``,
BiCGStab and GMRES in ``tests/test_torch_krylov_batch.py``). The queueing
layers that feed requests into these batches, and into a
:class:`LaneRunner`'s lanes, are ``repro_torch.runtime.solver_service``'s
``SolverService`` and ``AsyncSolverService``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.core import perks
from repro_torch.core.cache_policy import CacheableArray
from repro_torch.exec.problem import HaloSpec, Problem, _leaves


def _map(fn, *xs):
    """``fn`` over the tensors of one or more like states: a tensor, or a
    tuple of them (element by element)."""
    if isinstance(xs[0], tuple):
        return tuple(fn(*es) for es in zip(*xs))
    return fn(*xs)


def _stack(states: Sequence[Any]):
    """Stack like states (tensors or tuples of tensors) on a new leading
    axis."""
    return _map(lambda *ts: torch.stack([torch.as_tensor(t) for t in ts]),
                *states)


def _lane(state, i: int):
    """Lane ``i`` of a stacked state."""
    return _map(lambda t: t[i], state)


def _pack(state, steps: torch.Tensor) -> tuple:
    """A lane group's flat carry: the state's tensors, then the step
    counters (``core.perks`` runs on a tensor or a flat tuple)."""
    return (*state, steps) if isinstance(state, tuple) else (state, steps)


def _unpack(carry: tuple):
    """(state, steps) of a flat carry (a one-tensor state as a tensor)."""
    state = carry[:-1]
    return (state[0] if len(state) == 1 else state), carry[-1]


def stack_payloads(problems: Sequence[Problem]):
    """Stack every instance's payload along a new leading axis."""
    return _stack([p.payload() for p in problems])


def per_instance_chip(chip, batch: int):
    """The on-chip budget ONE instance of a B-wide batch may plan against.

    A batched resident launch keeps every lane's working set on chip at
    once, so residency and scratch share the card's shared memory. A lane
    of a batched stencil launch runs on ``sms // B`` CTAs of the full
    per-block shared memory, one an SM: that is the lane's ``sms`` and,
    at most, its ``onchip_bytes`` (``(sms // B) * smem_per_block``; never
    more than ``onchip_bytes / B``, the budget every family shares, which
    makes a batched problem demote residency first rather than emit plans
    whose combined working set oversubscribes the card)."""
    if batch <= 1:
        return chip
    lane = dataclasses.replace(chip, onchip_bytes=chip.onchip_bytes / batch)
    if chip.sms:
        sms = chip.sms // batch
        lane = dataclasses.replace(lane, sms=sms, onchip_bytes=min(
            lane.onchip_bytes, sms * chip.smem_per_block))
    return lane


class BatchedProblem(Problem):
    """B independent instances of one problem family as a single Problem.

    Instances must agree on :meth:`Problem.batch_key` (same family, shapes,
    dtypes, shared operands and step count), so one step function serves
    the whole batch. ``pad_to`` replicates the last instance up to a fixed
    width (the service uses it so that every batch of a key has one shape,
    and so one kept CUDA graph); padded lanes are dropped by :meth:`split`.
    A family without a batched step (``Problem.batched_step_fn``) raises
    ``NotImplementedError`` here.
    """

    kind = "batched"

    def __init__(self, instances: Sequence[Problem], *,
                 pad_to: Optional[int] = None):
        instances = tuple(instances)
        if not instances:
            raise ValueError("BatchedProblem needs at least one instance")
        if any(isinstance(p, BatchedProblem) for p in instances):
            raise ValueError("BatchedProblem instances cannot nest")
        keys = {p.batch_key() for p in instances}
        if len(keys) > 1:
            raise ValueError(
                f"instances are not batch-compatible; got {len(keys)} "
                f"distinct batch keys: {sorted(map(str, keys))[:3]} ...")
        self.pad = 0
        if pad_to is not None:
            if pad_to < len(instances):
                raise ValueError(
                    f"pad_to={pad_to} < {len(instances)} instances")
            self.pad = pad_to - len(instances)
            instances = instances + (instances[-1],) * self.pad
        self.instances = instances
        self.template = instances[0]
        self._step = self.template.batched_step_fn()
        self.batch = len(instances)
        self.kind = self.template.kind
        self.n_steps = self.template.n_steps
        self.name = f"batch{self.batch}_{self.template.name}"
        self.payload_stack = stack_payloads(instances)
        self._state0 = None

    @classmethod
    def from_instances(cls, instances: Sequence[Problem], *,
                       pad_to: Optional[int] = None) -> "BatchedProblem":
        return cls(instances, pad_to=pad_to)

    # -- protocol -------------------------------------------------------------

    def initial_state(self):
        # made once, so planning and a later execute read the same tensors
        if self._state0 is None:
            self._state0 = _stack([p.initial_state()
                                   for p in self.instances])
        return self._state0

    def step_fn(self) -> Callable[[Any, Any], Any]:
        return self._step

    def finalize(self, state):
        # the adapters' finalize is structural (tuple re-selection), so it
        # maps over the stacked state unchanged
        return self.template.finalize(state)

    def oracle(self):
        return _stack([p.oracle() for p in self.instances])

    def convergence(self):
        """The instances' shared predicate over the stacked state, with
        every instance's params stacked: ``pred(state, params)`` is a
        bool[B] lane vector from ONE device-side reduction (the families'
        predicates are elementwise over lanes). None if any instance
        declares no contract."""
        confs = [p.convergence() for p in self.instances]
        if any(c is None for c in confs):
            return None
        pred = confs[0][0]   # structurally identical across the batch key
        return pred, _stack([c[1] for c in confs])

    def on_sync(self) -> Optional[Callable[[Any, int], bool]]:
        """Batched convergence check: stop only when EVERY instance's own
        check passes (the batch shares one dispatch, so the slowest
        instance owns the step count). None if any instance never stops.

        Instances with a :meth:`Problem.convergence` contract are checked
        by one stacked reduction and ONE host transfer a sync point,
        whatever B is. Otherwise each lane's own ``on_sync`` is called on
        that lane's slice of the stacked state (B transfers a sync
        point)."""
        conv = self.convergence()
        if conv is not None:
            pred, params = conv
            return lambda state, k: bool(torch.all(pred(state, params)))
        cbs = [p.on_sync() for p in self.instances]
        if any(cb is None for cb in cbs):
            return None

        def all_done(state, k) -> bool:
            return all(cb(_lane(state, i), k) for i, cb in enumerate(cbs))

        return all_done

    def cacheable_arrays(self, *, fuse_steps: int = 1) -> Sequence[CacheableArray]:
        """Per-instance regions scale by B; shared operands (the CG matrix,
        ``array_scales_with_batch``) keep one copy: the B-scaled working
        set the planner prices."""
        out = []
        for a in self.template.cacheable_arrays(fuse_steps=fuse_steps):
            if self.template.array_scales_with_batch(a.name):
                a = dataclasses.replace(a, bytes=a.bytes * self.batch)
            out.append(a)
        return out

    def domain_bytes(self) -> int:
        return self.template.domain_bytes() * self.batch

    def halo_spec(self) -> Optional[HaloSpec]:
        return self.template.halo_spec()

    def supports(self, tier: str) -> bool:
        return tier in self.template.batched_tiers()

    def unsupported(self, tier: str) -> Optional[str]:
        """Why this batch does not run ``tier`` (None where it does): the
        family's own message for a resident tier with no batched launch."""
        if self.supports(tier):
            return None
        why = (self.template.batched_resident_missing if tier == "resident"
               else f"it does not run tier {tier!r}")
        return f"a batch of {type(self.template).__name__}: {why}"

    # -- batching surface -----------------------------------------------------

    def payload(self):
        return self.payload_stack

    def with_payload(self, payload) -> "BatchedProblem":
        # rebuild only the real instances and re-pad to the same width, so
        # the clone's split() keeps dropping the padded lanes
        real = self.batch - self.pad
        rebuilt = [inst.with_payload(_lane(payload, i))
                   for i, inst in enumerate(self.instances[:real])]
        return type(self)(rebuilt, pad_to=self.batch if self.pad else None)

    def batch_key(self) -> tuple:
        return ("batched", self.batch, self.template.batch_key())

    def array_scales_with_batch(self, name: str) -> bool:
        return self.template.array_scales_with_batch(name)

    def with_precision(self, precision: str) -> "BatchedProblem":
        """Precision applies to every lane alike (one step function serves
        the batch)."""
        if precision == "uniform":
            return self
        real = self.batch - self.pad
        rebuilt = [p.with_precision(precision)
                   for p in self.instances[:real]]
        return type(self)(rebuilt, pad_to=self.batch if self.pad else None)

    def split(self, result) -> list:
        """Per-instance results (padded lanes dropped), in instance order."""
        real = self.batch - self.pad
        return [_lane(result, i) for i in range(real)]

    # -- tiers ----------------------------------------------------------------

    def run_resident(self, plan):
        """One launch of the family's batched resident kernel over the
        stacked payloads."""
        return self.template.run_resident_batched(self.payload_stack, plan)


# -----------------------------------------------------------------------------
# Lane-level batching: the substrate of continuous batching
# -----------------------------------------------------------------------------

@dataclasses.dataclass
class LaneState:
    """Device-side state of one lane group (width fixed at construction).

    ``state`` is the stacked solver state (leading axis: lanes);
    ``steps_done`` is int32[width]: a lane with ``steps_done >= n_steps``
    is frozen (free or retired) and masked out of every group step;
    ``params`` is the stacked convergence params (None when the family
    declares no contract). :meth:`LaneRunner.admit` writes into these
    tensors in place, so their addresses never change.
    """

    state: Any
    steps_done: torch.Tensor
    params: Any = None


class LaneRunner:
    """Lane programs of one batch key for continuous batching.

    Where :class:`BatchedProblem` stacks a fixed membership for one
    dispatch sequence, a LaneRunner owns ``width`` lanes whose membership
    churns: a new instance enters a free lane at a barrier (:meth:`admit`),
    every occupied lane advances through the same masked group step
    (:meth:`step_fn`), a per-lane convergence vector is read with ONE
    stacked reduction (:meth:`convergence_vector`), and converged lanes
    retire (:meth:`harvest` + :meth:`retire`) without disturbing the rest.

    Masking makes heterogeneous progress safe inside one dispatch: a
    frozen lane's step output is computed but discarded (``torch.where``),
    so its state stays bit for bit. ``admit`` writes the new lane's state
    into the group's existing tensors (slice assignment), so a device
    loop's kept CUDA graph goes on reading the same addresses: an
    admission captures nothing new.
    """

    def __init__(self, template: Problem, width: int,
                 tracer: Optional["obs.Tracer"] = None):
        if isinstance(template, BatchedProblem):
            raise TypeError("LaneRunner wants a single-instance template; "
                            "it owns the lane stacking itself")
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        self.template = template
        self.width = width
        # a tracer pinned here wins; otherwise every emit resolves the
        # ambient tracer at call time
        self._tracer = tracer
        self.n_steps = int(template.n_steps)
        self._bstep = template.batched_step_fn()
        conv = template.convergence()
        self.has_convergence = conv is not None
        self._pred = conv[0] if self.has_convergence else None
        self._group_step = self._make_group_step()
        obs.get_metrics().counter("executor_retraces_total",
                                  tier="lane_runner").inc()
        tr = self._trace()
        if tr.enabled:
            tr.event("lane_compile", cat="compile", track=self._track(),
                     template=template.name, width=width,
                     n_steps=self.n_steps)

    def _trace(self) -> "obs.Tracer":
        return self._tracer if self._tracer is not None else obs.get_tracer()

    def _track(self) -> str:
        return f"lanes:{self.template.name}"

    # -- group stepping --------------------------------------------------------

    def _make_group_step(self):
        n, bstep = self.n_steps, self._bstep

        def group_step(carry, out):
            state, steps = _unpack(carry)
            nstate, nsteps = _unpack(out)
            active = steps < n
            new = bstep(state, nstate)
            sel = _map(lambda a, b, o: torch.where(
                active.reshape(active.shape + (1,) * (a.dim() - 1)), a, b,
                out=o), new, state, nstate)
            return _pack(sel, torch.add(steps, active.to(steps.dtype),
                                        out=nsteps))

        return group_step

    def step_fn(self) -> Callable[[Any, Any], Any]:
        """Masked group step (``core.perks``'s ``step(carry, out)``) over
        the flat carry ``(*state, steps_done)`` (:meth:`carry`): lanes
        advance only while ``steps_done < n_steps``; frozen lanes keep
        their state bit for bit (their computed update is discarded). One
        function a runner, so a device loop over it keeps one CUDA
        graph."""
        return self._group_step

    def carry(self, lanes: "LaneState") -> tuple:
        """The flat tuple the group step runs on: the state's tensors,
        then ``steps_done``."""
        return _pack(lanes.state, lanes.steps_done)

    def advance(self, lanes: "LaneState", steps: int,
                execution: perks.Execution = perks.Execution.DEVICE_LOOP
                ) -> "LaneState":
        """``steps`` group steps of every lane in one dispatch sequence
        (a device loop's kept graph, or a host loop), written back into
        the group's own tensors."""
        runner = perks.persistent(self._group_step, steps,
                                  perks.PerksConfig(execution=execution))
        got = runner(self.carry(lanes))
        for dst, src in zip(self.carry(lanes), got):
            dst.copy_(src)
        return lanes

    # -- lane lifecycle --------------------------------------------------------

    def fresh(self) -> LaneState:
        """An all-free lane group: every lane holds a frozen replica of
        the template's initial state (masked out until admitted)."""
        init = self.template.initial_state()
        state = _stack([init] * self.width)
        steps = torch.full((self.width,), self.n_steps, dtype=torch.int32,
                           device=_leaves(init)[0].device)
        params = None
        if self.has_convergence:
            _, p = self.template.convergence()
            params = _stack([p] * self.width)
        return LaneState(state=state, steps_done=steps, params=params)

    def admit(self, lanes: LaneState, lane: int, problem: Problem) -> LaneState:
        """Write ``problem``'s fresh state into a free lane mid-flight, in
        place: the lane's state row and convergence-params row are
        overwritten on the device and its step counter reset. The group's
        tensors keep their addresses."""
        if problem.batch_key() != self.template.batch_key():
            raise ValueError(
                f"cannot admit {problem.name}: batch key differs from this "
                f"runner's template ({self.template.name})")

        def put(group, x):
            group[lane].copy_(torch.as_tensor(x))

        _map(put, lanes.state, problem.initial_state())
        lanes.steps_done[lane] = 0
        if self.has_convergence:
            _, p = problem.convergence()
            _map(put, lanes.params, p)
        tr = self._trace()
        if tr.enabled:
            tr.event("lane_admit", cat="lane", track=self._track(),
                     lane=lane, problem=problem.name)
        obs.get_metrics().counter("lane_admissions_total").inc()
        return lanes

    def convergence_vector(self, lanes: LaneState):
        """bool[width] of per-lane convergence: ONE stacked device-side
        reduction and ONE host transfer, never a round trip a lane. None
        when the family declares no contract."""
        if not self.has_convergence:
            return None
        return self._pred(lanes.state, lanes.params).cpu().numpy()

    def harvest(self, lanes: LaneState, lane: int):
        """The finalized result of one lane (a copy of its rows)."""
        return self.template.finalize(_map(lambda t: t[lane].clone(),
                                           lanes.state))

    def retire(self, lanes: LaneState, lane: int) -> LaneState:
        """Freeze a lane (converged or exhausted): its counter jumps to
        ``n_steps`` so the group step masks it out from now on."""
        tr = self._trace()
        if tr.enabled:
            tr.event("lane_retire", cat="lane", track=self._track(),
                     lane=lane)
        obs.get_metrics().counter("lane_retirements_total").inc()
        lanes.steps_done[lane] = self.n_steps
        return lanes


def execute_sequential(problems: Sequence[Problem], plan, *, mesh=None) -> list:
    """The unbatched baseline: each instance through its own dispatch
    sequence (``execute`` per instance, the same single-instance plan)."""
    from repro_torch.exec.executor import execute
    if plan.batch != 1:
        raise ValueError("execute_sequential wants a single-instance plan")
    return [execute(p, plan, mesh=mesh) for p in problems]


def autotune_batch_sweep(instances: Sequence[Problem],
                         batches: Sequence[int] = (1, 2, 4, 8),
                         **autotune_kw) -> dict:
    """``autotune`` at several batch widths: for each B, the planner's top
    candidates measured on a B-wide :class:`BatchedProblem` of the first B
    instances. Returns ``{B: AutotuneResult}``; each winner's
    per-instance time is ``measured_s / B``."""
    from repro_torch.exec.executor import autotune
    instances = list(instances)
    out = {}
    for b in batches:
        if b < 1 or b > len(instances):
            raise ValueError(
                f"batch {b} needs 1..{len(instances)} instances")
        out[b] = autotune(BatchedProblem.from_instances(instances[:b]),
                          **autotune_kw)
    return out
