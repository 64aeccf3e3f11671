"""repro_torch.exec — the PERKS executor of the port:

    Problem  ->  plan()/plan_candidates()  ->  execute()

* :class:`StencilProblem`, :class:`CGProblem` (``adapters.py``) — the
  paper's stencil and conjugate-gradient workloads;
  :class:`BiCGStabProblem`, :class:`GMRESProblem` (``krylov.py``) — the
  nonsymmetric Krylov family; :class:`DecodeAttentionProblem`,
  :class:`SSMScanProblem` (``ml.py``) — LM decode and the Mamba2 SSD scan.
* :class:`Plan` (``plan.py``) — how to run, with the reference's JSON
  schema.
* :func:`plan` (``planner.py``) — ranks host_loop / device_loop / resident
  candidates with the paper's performance model on the H100.
* :func:`execute` / :func:`autotune` (``executor.py``) — the single
  dispatch path, and measured top-k plan selection (the drift ledger,
  ``repro_torch.obs``, skips what it has measured).
* :class:`BatchedProblem` (``batch.py``) — B instances behind one
  dispatch a step; ``plan(problem, batch=B)`` prices the B-scaled working
  set, and ``runtime/solver_service.py`` serves request queues through
  it.
"""
from repro_torch.exec.adapters import (
    CGProblem,
    StencilProblem,
    fused_block_rows,
    fusion_schedule,
    operator_fingerprint,
)
from repro_torch.exec.batch import (
    BatchedProblem,
    LaneRunner,
    LaneState,
    autotune_batch_sweep,
    execute_sequential,
    per_instance_chip,
    stack_payloads,
)
from repro_torch.exec.executor import (
    AutotuneResult,
    TimingRow,
    autotune,
    execute,
    honors_on_sync,
)
from repro_torch.exec.krylov import BiCGStabProblem, GMRESProblem
from repro_torch.exec.ml import DecodeAttentionProblem, SSMScanProblem
from repro_torch.exec.plan import SCHEDULES, TIERS, CacheDecision, Plan
from repro_torch.exec.planner import cg_policy, plan, plan_candidates
from repro_torch.exec.precision import (
    PRECISIONS,
    compensated_vdot,
    dot_for,
    solve_refined,
)
from repro_torch.exec.problem import HaloSpec, Problem, operand_fingerprint

__all__ = [
    "AutotuneResult",
    "BatchedProblem",
    "BiCGStabProblem",
    "CGProblem",
    "CacheDecision",
    "DecodeAttentionProblem",
    "HaloSpec",
    "GMRESProblem",
    "LaneRunner",
    "LaneState",
    "PRECISIONS",
    "Plan",
    "Problem",
    "SCHEDULES",
    "SSMScanProblem",
    "StencilProblem",
    "TIERS",
    "TimingRow",
    "autotune",
    "autotune_batch_sweep",
    "cg_policy",
    "compensated_vdot",
    "dot_for",
    "execute",
    "execute_sequential",
    "fused_block_rows",
    "fusion_schedule",
    "honors_on_sync",
    "operand_fingerprint",
    "operator_fingerprint",
    "per_instance_chip",
    "plan",
    "plan_candidates",
    "solve_refined",
    "stack_payloads",
]
