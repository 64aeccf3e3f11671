"""repro_torch.exec — the PERKS executor of the port:

    Problem  ->  plan()/plan_candidates()  ->  execute()

* :class:`StencilProblem` (``adapters.py``) — the paper's stencil workload.
* :class:`Plan` (``plan.py``) — how to run, with the reference's JSON
  schema.
* :func:`plan` (``planner.py``) — ranks host_loop / device_loop / resident
  candidates with the paper's performance model on the H100.
* :func:`execute` (``executor.py``) — the single dispatch path.
"""
from repro_torch.exec.adapters import StencilProblem, fusion_schedule
from repro_torch.exec.executor import execute, honors_on_sync
from repro_torch.exec.plan import SCHEDULES, TIERS, CacheDecision, Plan
from repro_torch.exec.planner import plan, plan_candidates
from repro_torch.exec.problem import HaloSpec, Problem, operand_fingerprint

__all__ = [
    "CacheDecision",
    "HaloSpec",
    "Plan",
    "Problem",
    "SCHEDULES",
    "StencilProblem",
    "TIERS",
    "execute",
    "fusion_schedule",
    "honors_on_sync",
    "operand_fingerprint",
    "plan",
    "plan_candidates",
]
