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
* :func:`execute` (``executor.py``) — the single dispatch path.
"""
from repro_torch.exec.adapters import (
    CGProblem,
    StencilProblem,
    fused_block_rows,
    fusion_schedule,
    operator_fingerprint,
)
from repro_torch.exec.executor import execute, honors_on_sync
from repro_torch.exec.krylov import BiCGStabProblem, GMRESProblem
from repro_torch.exec.ml import DecodeAttentionProblem, SSMScanProblem
from repro_torch.exec.plan import SCHEDULES, TIERS, CacheDecision, Plan
from repro_torch.exec.planner import cg_policy, plan, plan_candidates
from repro_torch.exec.precision import compensated_vdot, solve_refined
from repro_torch.exec.problem import HaloSpec, Problem, operand_fingerprint

__all__ = [
    "BiCGStabProblem",
    "CGProblem",
    "CacheDecision",
    "DecodeAttentionProblem",
    "HaloSpec",
    "GMRESProblem",
    "Plan",
    "Problem",
    "SCHEDULES",
    "SSMScanProblem",
    "StencilProblem",
    "TIERS",
    "cg_policy",
    "compensated_vdot",
    "execute",
    "fused_block_rows",
    "fusion_schedule",
    "honors_on_sync",
    "operand_fingerprint",
    "operator_fingerprint",
    "plan",
    "plan_candidates",
    "solve_refined",
]
