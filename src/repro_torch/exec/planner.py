"""``plan(problem)``: the planner of the port — the ``_stencil_candidates``
and ``_cg_candidates`` branches of ``repro/exec/planner.py`` for one
instance on one card. The CG branch serves the Krylov family (``"cg"``,
``"bicgstab"``, ``"gmres"``) with the reference's gates: no VEC candidate
for GMRES, and its MIX only when all of A fits beside the basis (the cycle
kernel streams no row of A).

It enumerates the host_loop, device_loop and resident candidates, prices
each with the paper's performance model (``core.perf_model``, Eq. 5 as
``gm_bytes_fused`` for stencils; the reference's per-array traffic for
CG) plus a per-dispatch launch term, and ranks them by projected time.
The device loop is one dispatch only once its CUDA graph is kept for this
problem (``core.perks.graph_cached``); until then its next run also
captures the graph, charged as one launch per captured launch. Stencil
resident candidates are emitted at ``fuse_steps=1`` only, and no
deep-schedule candidate at all, until the CUDA kernel fuses steps
(ROADMAP).

A Krylov host loop pays its kind's launches per step (the reference
charges one): ``problem.step_launches()``, i.e.
``adapters.CG_STEP_LAUNCHES``, ``krylov.BICGSTAB_STEP_LAUNCHES`` or
``krylov.GMRES_CYCLE_LAUNCHES(m)``; a chunked device loop
(``sync_every < n_steps``) never keeps its graphs, so it always pays the
capture plus one dispatch per chunk. Everything else is the reference's formula.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

from repro_torch.core import perks
from repro_torch.core.cache_policy import (
    cg_arrays,
    cg_arrays_for,
    gm_bytes_fused,
    plan_caching,
)
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


def _budget_chip(chip: Chip, budget_bytes: Optional[int]) -> Chip:
    """Override the chip's on-chip capacity (proxy-capacity regimes)."""
    if budget_bytes is None:
        return chip
    return dataclasses.replace(chip, onchip_bytes=float(budget_bytes))


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


def cg_policy_from_arrays(arrays, budget_bytes: int) -> dict:
    """The Fig.-9 policy decision (IMP/VEC/MIX) from a cache plan, as the
    reference decides it. "Vectors" are every array that is not the
    operator A."""
    cplan = plan_caching(arrays, budget_bytes)
    vec_frac = min(cplan.fraction_of(a.name) for a in arrays
                   if a.name != "A")
    mat_frac = cplan.fraction_of("A")
    if vec_frac < 1.0:
        policy = "IMP"          # vectors don't even fit -> rely on caches
    elif mat_frac > 0.0:
        policy = "MIX"          # all of A, or partial matrix residency
    else:
        policy = "VEC"
    return {"policy": policy, "vector_fraction": vec_frac,
            "matrix_fraction": mat_frac,
            "traffic_saved_per_iter": cplan.traffic_saved_per_step,
            "_plan": cplan}


def _cg_candidates(problem, chip: Chip, *,
                   sync_every: Optional[int]) -> list[Plan]:
    from repro_torch.exec.adapters import fused_block_rows

    arrays = list(problem.cacheable_arrays())
    budget = int(chip.onchip_bytes * 0.9)
    pol = cg_policy_from_arrays(arrays, budget)
    cplan = pol["_plan"]
    n = problem.n_steps
    if sync_every is None and problem.on_sync() is not None and n > 1:
        # the problem declares a convergence check (tol): default to the
        # reference's check cadence, capped so one check lands before the
        # end
        sync_every = min(25, max(1, n - 1))

    total_bytes = sum(a.bytes * (a.loads_per_step + a.stores_per_step)
                      for a in arrays)
    vec_traffic = sum(a.bytes * (a.loads_per_step + a.stores_per_step)
                      for a in arrays if a.name != "A")
    cache = tuple(CacheDecision(a.array.name, a.cached_bytes, a.array.bytes)
                  for a in cplan.assignments)
    common = dict(n_steps=n, problem=problem.name, chip=chip.name,
                  sync_every=sync_every)
    launches = problem.step_launches()
    chunks = -(-n // sync_every) if sync_every and sync_every < n else 1
    captures = n * launches
    if chunks == 1 and perks.graph_cached(problem.step_fn(),
                                          problem.initial_state(), n):
        captures = 0
    cands = [
        Plan(tier="host_loop",
             predicted_s=n * (total_bytes / chip.hbm_bw
                              + launches * DISPATCH_OVERHEAD_S), **common),
        Plan(tier="device_loop", policy="IMP",
             predicted_s=n * total_bytes / chip.hbm_bw
             + (captures + chunks) * DISPATCH_OVERHEAD_S, **common),
    ]
    kind = problem.kind
    if problem.data is not None and pol["vector_fraction"] >= 1.0:
        bm = fused_block_rows(problem.b.shape[0])
        # cached bytes still move through on-chip memory every iteration
        # (Eq. 7)
        vec_cache = tuple(c for c in cache if c.name != "A")
        t_sm_vec = sm_bytes_accessed(n, sum(c.cached_bytes
                                            for c in vec_cache))
        if kind != "gmres":
            cands.append(Plan(
                tier="resident", policy="VEC", block_rows=bm,
                cache=vec_cache,
                predicted_s=max(n * (total_bytes - vec_traffic)
                                / chip.hbm_bw, t_sm_vec / chip.onchip_bw)
                + DISPATCH_OVERHEAD_S, **common))
        # the GMRES cycle kernel holds the whole of A beside the basis
        # (no streamed-A variant), so a partial-A MIX plan has no kernel
        if pol["matrix_fraction"] > 0.0 and (
                kind != "gmres" or pol["matrix_fraction"] >= 1.0):
            saved = cplan.traffic_saved_per_step
            t_sm_all = sm_bytes_accessed(n, sum(c.cached_bytes
                                                for c in cache))
            cands.append(Plan(
                tier="resident", policy="MIX", block_rows=bm, cache=cache,
                predicted_s=max(n * max(0.0, total_bytes - saved)
                                / chip.hbm_bw, t_sm_all / chip.onchip_bw)
                + DISPATCH_OVERHEAD_S, **common))
    return cands


def plan_candidates(problem: Problem, *, chip: Union[str, Chip] = "h100",
                    sub_rows: int = 128, budget_bytes: Optional[int] = None,
                    sync_every: Optional[int] = None) -> list[Plan]:
    """Every candidate Plan for ``problem``, ranked by projected time.
    Planning reads shapes only; it launches nothing. ``budget_bytes``
    replaces the card's on-chip capacity (the reference's proxy regimes);
    ``sync_every`` sets CG's host-check cadence."""
    chip = _budget_chip(_as_chip(chip), budget_bytes)
    if problem.batch != 1:
        raise NotImplementedError("batched planning is not ported yet "
                                  "(ROADMAP)")
    if problem.kind == "stencil":
        cands = _stencil_candidates(problem, chip, sub_rows=sub_rows)
    elif problem.kind in ("cg", "bicgstab", "gmres"):
        cands = _cg_candidates(problem, chip, sync_every=sync_every)
    else:
        raise NotImplementedError(
            f"no candidate generator for problem kind {problem.kind!r}")
    return _rank([c for c in cands if problem.supports(c.tier)])


def plan(problem: Problem, *, chip: Union[str, Chip] = "h100",
         sub_rows: int = 128, budget_bytes: Optional[int] = None,
         sync_every: Optional[int] = None) -> Plan:
    """The planner's top candidate for ``problem``."""
    return plan_candidates(problem, chip=chip, sub_rows=sub_rows,
                           budget_bytes=budget_bytes,
                           sync_every=sync_every)[0]


def cg_policy(n_rows: Optional[int] = None, nnz: Optional[int] = None,
              dtype_bytes: int = 4, *, chip: Union[str, Chip] = "h100",
              matrix=None, budget_bytes: Optional[int] = None) -> dict:
    """The Fig.-9 policy dict (policy + fractions) for a matrix, or for
    ``n_rows``/``nnz``, under ``budget_bytes`` (default 90% of the card's
    on-chip capacity)."""
    chip = _as_chip(chip)
    if matrix is not None:
        arrays = cg_arrays_for(matrix)
    else:
        arrays = cg_arrays(n_rows, nnz, dtype_bytes)
    budget = (int(chip.onchip_bytes * 0.9) if budget_bytes is None
              else int(budget_bytes))
    out = cg_policy_from_arrays(arrays, budget)
    out.pop("_plan")
    return out
