"""``plan(problem)``: the stencil planner of the port — the
``_stencil_candidates`` branch of ``repro/exec/planner.py`` for one
instance on one card.

It enumerates the host_loop, device_loop and resident candidates, prices
each with the paper's performance model (``core.perf_model``, Eq. 5 as
``gm_bytes_fused``) plus a per-dispatch launch term, and ranks them by
projected time. The device loop is one dispatch only once its CUDA graph
is kept for this problem (``core.perks.graph_cached``); until then its
next run also captures the graph, charged as one launch per step.
Resident candidates are emitted at ``fuse_steps=1`` only, and no
deep-schedule candidate at all, until the CUDA kernel fuses steps
(ROADMAP).
"""
from __future__ import annotations

import math
from typing import Union

from repro_torch.core import perks
from repro_torch.core.cache_policy import gm_bytes_fused
from repro_torch.core.hardware import CHIPS, Chip, device_chip
from repro_torch.core.perf_model import project_host_loop, sm_bytes_accessed
from repro_torch.exec.plan import CacheDecision, Plan
from repro_torch.exec.problem import Problem
from repro_torch.kernels.stencil3d import plan_resident_planes

#: Host cost charged per launch; HOST_LOOP pays it n_steps times, the
#: one-dispatch tiers once. Measured by ``chip_smoke.py`` as the per-step
#: time of the host loop on a 64x64 domain (where the kernel is negligible)
#: on an H100 SXM at a 700 W power limit: the median of three runs was
#: 25 microseconds, nearly all of it Python and launch cost.
DISPATCH_OVERHEAD_S = 25e-6


def _as_chip(chip: Union[str, Chip]) -> Chip:
    """A ``Chip``, or a name from ``CHIPS`` read with the card's own SM
    count and shared memory when a card is present."""
    if isinstance(chip, Chip):
        return chip
    return device_chip(CHIPS[chip])


def _rank(cands: list[Plan]) -> list[Plan]:
    # predicted time first; ties prefer fewer barriers, then more cached bytes
    return sorted(cands, key=lambda p: (p.predicted_s, p.barriers,
                                        -p.cached_bytes))


def _stencil_candidates(problem, chip: Chip, *, sub_rows: int) -> list[Plan]:
    shape = tuple(problem.x.shape)
    db = problem.x.element_size()
    cells = int(math.prod(shape))
    row_bytes = int(math.prod(shape[1:])) * db
    domain_bytes = cells * db
    n = problem.n_steps
    r = problem.spec.radius
    base = project_host_loop(chip, n_steps=n, domain_cells=cells,
                             dtype_bytes=db)
    common = dict(n_steps=n, problem=problem.name, chip=chip.name)
    captures = 0 if perks.graph_cached(problem.step_fn(),
                                       problem.initial_state(), n) else n
    cands = [
        Plan(tier="host_loop", predicted_s=base.t_total
             + n * DISPATCH_OVERHEAD_S, predicted_bound=base.bound, **common),
        Plan(tier="device_loop", predicted_s=base.t_total
             + (captures + 1) * DISPATCH_OVERHEAD_S,
             predicted_bound=base.bound, **common),
    ]
    rows = plan_resident_planes(shape, db, problem.spec, chip=chip)
    cached_bytes = rows * row_bytes
    gm = gm_bytes_fused(n, domain_bytes, cached_bytes, row_bytes=row_bytes,
                        radius=r, fuse_steps=1)
    t_gm = gm / chip.hbm_bw
    t_sm = sm_bytes_accessed(n, cached_bytes) / chip.onchip_bw
    cands.append(Plan(
        tier="resident", fuse_steps=1, cached_rows=rows, sub_rows=sub_rows,
        cache=(CacheDecision("domain_rows", cached_bytes, domain_bytes),),
        predicted_s=max(t_gm, t_sm) + DISPATCH_OVERHEAD_S,
        predicted_bound="main_memory" if t_gm >= t_sm else "onchip_memory",
        **common))
    return cands


def plan_candidates(problem: Problem, *, chip: Union[str, Chip] = "h100",
                    sub_rows: int = 128) -> list[Plan]:
    """Every candidate Plan for ``problem``, ranked by projected time.
    Planning reads shapes only; it launches nothing."""
    chip = _as_chip(chip)
    if problem.batch != 1:
        raise NotImplementedError("batched planning is not ported yet "
                                  "(ROADMAP)")
    if problem.kind != "stencil":
        raise NotImplementedError(
            f"no candidate generator for problem kind {problem.kind!r}")
    cands = _stencil_candidates(problem, chip, sub_rows=sub_rows)
    return _rank([c for c in cands if problem.supports(c.tier)])


def plan(problem: Problem, *, chip: Union[str, Chip] = "h100",
         sub_rows: int = 128) -> Plan:
    """The planner's top candidate for ``problem``."""
    return plan_candidates(problem, chip=chip, sub_rows=sub_rows)[0]
