"""``execute(problem, plan)`` — the single dispatch path over the
single-device tiers, the port of ``repro/exec/executor.py`` (observability,
the drift ledger and autotune come in later slices).
"""
from __future__ import annotations

import warnings

from repro_torch.core import perks
from repro_torch.exec.plan import Plan
from repro_torch.exec.problem import Problem


def execute(problem: Problem, plan: Plan, *, mesh=None):
    """Run ``problem`` under ``plan``; returns the problem's final result.

    The loop tiers run the problem's step function through the
    ``core.perks`` combinators; the resident tier is the problem's own
    hook. The distributed tier is not ported yet and raises.
    """
    if plan.n_steps and plan.n_steps != problem.n_steps:
        raise ValueError(
            f"plan.n_steps={plan.n_steps} != problem.n_steps="
            f"{problem.n_steps}; plans are per-problem-instance")
    if plan.batch != problem.batch:
        raise ValueError(
            f"plan.batch={plan.batch} != problem.batch={problem.batch}")
    if not problem.supports(plan.tier):
        raise NotImplementedError(
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
    return _dispatch(problem, plan, mesh, on_sync)


def _dispatch(problem: Problem, plan: Plan, mesh, on_sync):
    """The tier dispatch proper (validation lives in ``execute``)."""
    if plan.tier == "distributed":
        if mesh is None:
            raise ValueError("distributed plan needs mesh=")
        return problem.run_distributed(plan, mesh)
    if plan.tier == "resident":
        return problem.run_resident(plan)
    execution = (perks.Execution.HOST_LOOP if plan.tier == "host_loop"
                 else perks.Execution.DEVICE_LOOP)
    cfg = perks.PerksConfig(execution=execution, sync_every=plan.sync_every,
                            fuse_steps=plan.fuse_steps)
    runner = perks.persistent(problem.step_fn(), problem.n_steps, cfg,
                              on_sync=on_sync)
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
