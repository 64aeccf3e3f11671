"""``plan(problem)``: the planner of the port — the ``_stencil_candidates``,
``_cg_candidates`` and ``_ml_candidates`` branches of
``repro/exec/planner.py`` on one card, for one instance or a batch of B
in one dispatch (``batch=``, or a ``BatchedProblem``), re-ranked by the
drift ledger where it has measured the candidates. The CG branch
serves the Krylov family (``"cg"``, ``"bicgstab"``, ``"gmres"``) with the
reference's gates: no VEC candidate for GMRES, and its MIX only when all
of A fits beside the basis (the cycle kernel streams no row of A).

It enumerates the host_loop, device_loop and resident candidates, prices
each with the paper's performance model (``core.perf_model``; the
reference's per-array traffic for CG) plus a per-dispatch launch term, and
ranks them by projected time. The device loop is one dispatch only once
its CUDA graph is kept for this problem (``core.perks.graph_cached``);
until then its next run also captures the graph, charged as one launch per
captured launch.

Stencil resident candidates are the reference's two loops: the shallow
schedule at t = 1, 2, 4, ... up to ``max_fuse`` (default 4), and the deep
schedule at t = 2, 4, ... up to ``DEEP_MAX_FUSE``. t = 1 is
``csrc/stencil_perks.cu`` (its own byte model, ``gm_bytes_perks``), or
``csrc/stencil_resident.cu`` with every row cached (Eq. 5,
``gm_bytes_fused``), and priced by its steps, whatever the bytes
(``one_step_compute_s``: a grid barrier and the box's and strips' work a
step); t > 1 is ``csrc/stencil_shallow.cu`` (shallow) or
``csrc/stencil_tb.cu`` (deep), priced by the port's own byte model of them
(``gm_bytes_tb``: halo re-reads of their tiles or strips and the deep
segments' warm-up rows included) and by their levels, whatever the bytes
(``tb_compute_s``): each pass's ``stencil2d.shallow_pass_cost`` at
``TB_SHALLOW_TERM_S`` or ``stencil2d.deep_pass_cost`` at
``TB_DEEP_LANE_CELL_S``, which count the tiles' recomputed halos or the
strips' side halos, the segments' warm-up rows and the levels' lag, so
they grow with the depth (``stencil_model_bytes`` and ``stencil_model_s``
give both for any plan). Each candidate's cached rows and layout are those
the kernel takes in ONE CTA's shared memory (``stencil2d.tb_layout``,
``resident_layout``, the card's per-block limit, or the H100 data sheet's
on the CPU): a depth the kernel cannot run is not offered, and the first
deep overflow ends the deep sweep.

The ML branch (``_ml_candidates``) prices ``DecodeAttentionProblem`` and
``SSMScanProblem`` with the reference's traffic model on the H100: per-step
streamed bytes from ``cacheable_arrays``, the resident tier eliding the
``carry_names`` round trips and offered only when
``resident_scratch_bytes`` fits 0.9 of the on-chip bytes and no
convergence check is declared (EOS decode lands on a chunked device loop).

A Krylov host loop pays its kind's launches per step (the reference
charges one): ``problem.step_launches()``, i.e.
``adapters.CG_STEP_LAUNCHES``, ``krylov.BICGSTAB_STEP_LAUNCHES`` or
``krylov.GMRES_CYCLE_LAUNCHES(m)``; a Krylov device loop pays the same
launches at ``GRAPH_LAUNCH_S`` each once its graph is kept and replays; a
chunked device loop (``sync_every < n_steps``) never keeps its graphs, so
it always pays the capture plus one dispatch per chunk. Everything else is the reference's formula.
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
    gm_bytes_perks,
    gm_bytes_tb,
    plan_caching,
)
from repro_torch.core.hardware import CHIPS, Chip, device_chip
from repro_torch.core.perf_model import project_host_loop, sm_bytes_accessed
from repro_torch.exec.plan import CacheDecision, Plan
from repro_torch.exec.problem import Problem
from repro_torch.kernels import stencil2d
from repro_torch.kernels.krylov_fused import gmres_cycle_rounds
from repro_torch.kernels.stencil3d import plan_resident_planes

#: Host cost charged per launch; HOST_LOOP pays it n_steps times, the
#: one-dispatch tiers once. Measured by ``chip_smoke.py`` as the per-step
#: time of the host loop on a 64x64 domain (where the kernel is negligible)
#: on an H100 SXM at a 700 W power limit: the median of three runs was
#: 25 microseconds, nearly all of it Python and launch cost.
DISPATCH_OVERHEAD_S = 25e-6

#: Depth ceiling of the deep resident candidates (the reference's
#: ``DEEP_MAX_FUSE``): the deep schedule has no r*t recompute window, so its
#: depths run past ``max_fuse`` as far as the kernel's layout fits.
DEEP_MAX_FUSE = 32

#: What the temporal-blocking levels cost whatever their bytes, by
#: schedule: seconds a term (a stencil point, and one more for the cell's
#: own load and store) of a cell a thread of ``stencil2d.shallow_pass_cost``
#: (``csrc/stencil_shallow.cu``: every thread's units over the tiles' rows
#: widened by their recomputed halos, a level's and a tile's set-up, waves
#: of 132 tiles), fitted to 2d5pt 8192x8192 x 100 at t = 4 (13.26 ms; in
#: a later sweep 13.07 ms priced 1.02x, 3d7pt 256^3 t = 2 and 4 0.92x and
#: 0.94x of 8.63 and 13.91 ms); and seconds a
#: lane-cell of ``stencil2d.deep_pass_cost`` (``csrc/stencil_tb.cu``: the
#: level pipeline's cells over its lanes, its per-row set-up, warm-up rows
#: and lag), fitted to 2d5pt 8192x8192 x 100 at t = 8 (32.43 ms; on the
#: sweep's other depths 0.77-1.19x the measured time, 0.65x at 3d7pt t =
#: 16, whose side halos it counts). Both measured by ``chip_smoke.py`` and
#: ``scripts/kernel_variants.py`` on an NVIDIA H100 80GB HBM3 at a 700 W
#: power limit (PERF.md).
TB_SHALLOW_TERM_S = 1.576e-8
TB_DEEP_LANE_CELL_S = 3.711e-7
#: The cached bands of a temporal-blocking plan (``csrc/stencil_band.cuh``,
#: the in-place update with its ring of old rows and table of row
#: pointers): seconds a term of a cell a thread of
#: ``stencil2d.band_pass_cost``, fitted to the shallow candidates with
#: cached bands on stencil small (2d5pt 3072x1152 x 1000) on an NVIDIA H100
#: 80GB HBM3 at a 700 W power limit (PERF.md).
TB_BAND_TERM_S = 9.5e-8
#: One-step resident plans, whatever their bytes, each step: a grid barrier
#: (``grid.sync()``, at most 2.61 us, PERF.md) and the band's work, seconds
#: a term of a cell a thread (as above) of ``stencil2d.resident_step_cost``
#: (every row cached) or of a band over the one-step kernel's threads;
#: fitted to stencil small (2d5pt 3072x1152 x 1000, ``stencil_resident``:
#: 10.1 ms, the barrier and halo copy 12-16% of a step by -DRES_PROFILE;
#: priced 0.98-0.99x of 10.23-10.33 ms in the final sweep) on an NVIDIA
#: H100 80GB HBM3 at a 700 W power limit (PERF.md).
RESIDENT_STEP_S = 2.1e-6
RESIDENT_TERM_S = 1.9e-8
#: One-step plans with rows streamed (``csrc/stencil_perks.cu``): seconds a
#: term of a cell a thread of ``stencil2d.perks_step_cost`` (a CTA's box and
#: its strips' tile rows, each row's wait and release counted as
#: PERKS_ROW_CELLS), the geometric mean of the two fits to 2d5pt 8192x8192
#: at 660 cached rows (35.33 ms) and 3d7pt 256^3 at 66 cached planes (17.03
#: ms), 100 steps each, in ``scripts/kernel_variants.py --kernels
#: perks_stream`` on an NVIDIA H100 80GB HBM3 at a 700 W power limit; it
#: prices them 1.24x and 0.81x (PERF.md).
PERKS_TERM_S = 4.41e-8
#: A reduction round of the fused CG and BiCGStab kernels
#: (``csrc/krylov_common.cuh`` tagged_round: a block barrier, a tagged
#: word released to L2 and every CTA's word acquired back, with the little
#: work between two rounds), charged ``KRYLOV_ROUNDS`` times an iteration
#: to their resident plans: an iteration on a 16x16 grid over its rounds,
#: the larger of the two kernels' figures (BiCGStab, 10.35-10.40 us over
#: three rounds), from ``scripts/kernel_variants.py --kernels krylov`` on
#: an NVIDIA H100 80GB HBM3 at a 700 W power limit; the ``[rounds]`` line
#: of ``chip_smoke.py`` prints the same figure (PERF.md).
KRYLOV_ROUND_S = 3.5e-6
KRYLOV_ROUNDS = {"cg": 2, "bicgstab": 3}
#: The GMRES cycle kernel (``csrc/gmres_cycle_fused.cu``) per tagged
#: round, charged ``gmres_cycle_rounds(m)`` = 1 + 3m times a cycle. It is
#: not the cost of a round (``KRYLOV_ROUND_S``) but the round's share of
#: a whole cycle, so it carries the SpMV, the projections and the updates
#: too, whose work grows with n and m: one m = 16 cycle on gmres-small
#: (``convdiff2d(448)``, n = 200,704) in a CUDA graph, 0.2063-0.2124 ms,
#: over its 49 rounds, from ``scripts/kernel_variants.py --kernels
#: krylov`` on an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md).
#: At other n or m the price drifts.
GMRES_ROUND_SHARE_S = 4.3e-6
#: A launch replayed from a kept CUDA graph of a Krylov device loop, over
#: and above its bytes: the loop's many small launches (19 an iteration of
#: CG, 40 of BiCGStab, 677 a GMRES(16) cycle, 630 when this was fitted)
#: run back to back, each paying its launch and tail. The median over cg-small, bicgstab-small
#: and gmres-small of (kept device loop - its priced bytes) / launches
#: (1.82, 2.00 and 2.19 us; 4.18, 9.33 and 5.58 ms measured), from the
#: ``[cg tiers]`` and ``[krylov tiers]`` lines of ``chip_smoke.py`` on an
#: NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md).
GRAPH_LAUNCH_S = 2.0e-6


def krylov_round_s(problem) -> float:
    """Seconds of tagged rounds a step of the problem's fused kernel:
    ``KRYLOV_ROUNDS`` at ``KRYLOV_ROUND_S`` an iteration of CG or BiCGStab,
    ``gmres_cycle_rounds(m)`` at ``GMRES_ROUND_SHARE_S`` a GMRES(m) cycle
    (which carries the cycle's work between rounds too)."""
    if problem.kind == "gmres":
        return gmres_cycle_rounds(problem.m) * GMRES_ROUND_SHARE_S
    return KRYLOV_ROUNDS.get(problem.kind, 0) * KRYLOV_ROUND_S


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


def _stencil_candidates(problem, chip: Chip, *, sub_rows: int,
                        max_fuse: int, batch: int = 1,
                        runs=None, graph_kept: bool = False) -> list[Plan]:
    """The stencil candidates of one instance ``problem``, priced for a
    batch of ``batch`` of them in one dispatch (``runs``, the problem that
    runs: the ``BatchedProblem`` itself, whose kept graph the device loop
    looks for; ``graph_kept`` prices the device loop as a replay all the
    same). A batch's memory traffic scales by B, its launches do not.

    A batch's resident candidates are one launch with a lane of ``sms //
    B`` CTAs a domain (``batch.per_instance_chip``): each laid out and
    fitted as one domain on the lane's CTAs, priced as the lane's pass
    with the card's bandwidths shared by B lanes, plus one launch. Where B
    exceeds the SMs no resident candidate is offered: the lanes of one
    cooperative launch are co-resident (the reference vmaps any B; waves
    of lanes are not ported)."""
    from repro_torch.exec.batch import per_instance_chip

    runs = problem if runs is None else runs
    B = batch
    shape = tuple(problem.x.shape)
    db = problem.x.element_size()
    cells = int(math.prod(shape))
    row_bytes = int(math.prod(shape[1:])) * db
    domain_bytes = cells * db
    n = problem.n_steps
    r = problem.spec.radius
    base = project_host_loop(chip, n_steps=n, domain_cells=cells,
                             dtype_bytes=db)
    common = dict(n_steps=n, problem=runs.name, chip=chip.name, batch=B)
    captures = 0 if graph_kept or perks.graph_cached(
        runs.step_fn(), runs.initial_state(), n) else n
    cands = [
        Plan(tier="host_loop", predicted_s=B * base.t_total
             + n * DISPATCH_OVERHEAD_S, predicted_bound=base.bound, **common),
        Plan(tier="device_loop", predicted_s=B * base.t_total
             + (captures + 1) * DISPATCH_OVERHEAD_S,
             predicted_bound=base.bound, **common),
    ]
    smem = chip.smem_per_block - stencil2d.PERKS_STATIC_SMEM
    lane = per_instance_chip(chip, B)
    if lane.sms < 1:
        return cands
    # a lane's pass, its bytes and on-chip traffic at 1/B of the card's rates
    price = lane if B == 1 else dataclasses.replace(
        lane, hbm_bw=chip.hbm_bw / B, onchip_bw=chip.onchip_bw / B)

    def resident(t: int, schedule: str, rows: int, sub: int) -> Plan:
        p = Plan(tier="resident", schedule=schedule, fuse_steps=t,
                 cached_rows=rows, sub_rows=sub,
                 cache=(CacheDecision("domain_rows", rows * row_bytes,
                                      domain_bytes),), **common)
        s, bound_by = stencil_model_s(problem, p, chip=price)
        return dataclasses.replace(p, predicted_s=s + DISPATCH_OVERHEAD_S,
                                   predicted_bound=bound_by)

    # RESIDENT x shallow depth (t = 1 is csrc/stencil_perks.cu)
    t = 1
    while t <= max(1, min(max_fuse, n)):
        if t == 1:
            rows = plan_resident_planes(shape, db, problem.spec, chip=lane)
        else:
            if sub_rows < r * t:     # Plan.validate would refuse it
                break
            rows = stencil2d.tb_cached_rows(shape, r, t, db, deep=False,
                                            ctas=lane.sms, limit=smem)
            if rows is None:
                break
        cands.append(resident(t, "shallow", rows, sub_rows))
        t *= 2

    # RESIDENT x deep depth: the first depth whose layout does not fit one
    # CTA ends the sweep (the layout grows with t)
    deep_sub = max(sub_rows, r)
    t = 2
    while t <= max(1, min(max(max_fuse, DEEP_MAX_FUSE), n)):
        got = stencil2d.tb_cached_rows(shape, r, t, db, deep=True,
                                       ctas=lane.sms, limit=smem)
        if got is None:
            break
        cands.append(resident(t, "deep", got, deep_sub))
        t *= 2
    return cands


def _runs_tb(problem, p: Plan) -> bool:
    """Whether stencil plan ``p`` runs a temporal-blocking kernel,
    ``csrc/stencil_shallow.cu`` or ``csrc/stencil_tb.cu`` (the routing of
    ``StencilProblem.run_resident``)."""
    return (p.tier == "resident" and (p.cached_rows or 0) < problem.x.shape[0]
            and (p.schedule == "deep" or min(p.fuse_steps, problem.n_steps) > 1))


def stencil_model_bytes(problem, p: Plan, *,
                        chip: Union[str, Chip] = "h100") -> float:
    """Device-memory bytes the planner charges stencil plan ``p``: Eq. 5
    (``gm_bytes_fused`` at t = 1) for the loop tiers, the one-step kernel
    and the whole domain cached; the port's byte model of the
    temporal-blocking kernels (``gm_bytes_tb``, at the layout the kernel
    takes in one CTA of ``chip``) for temporal blocking."""
    shape, n = tuple(problem.x.shape), problem.n_steps
    db = problem.x.element_size()
    r = problem.spec.radius
    row_bytes = int(math.prod(shape[1:])) * db
    rows = (p.cached_rows or 0) if p.tier == "resident" else 0
    if p.tier == "resident" and not _runs_tb(problem, p):
        lay = _perks_layout(problem, p, _as_chip(chip))
        if lay is not None:
            return gm_bytes_perks(n, shape, db, radius=r, cached_rows=rows,
                                  boxes=(lay.nbz, lay.nby), strip=lay.strip,
                                  left=lay.window[0], strips=lay.nseg)
    if not _runs_tb(problem, p):
        return gm_bytes_fused(n, shape[0] * row_bytes, rows * row_bytes,
                              row_bytes=row_bytes, radius=r, fuse_steps=1)
    lay = _tb_layout(problem, p, _as_chip(chip))
    return gm_bytes_tb(n, shape, db, radius=r, fuse_steps=min(p.fuse_steps, n),
                       cached_rows=rows, bands=lay.nb, strip=lay.strip,
                       rows=lay.rows, deep=p.schedule == "deep")


def _perks_layout(problem, p: Plan, chip: Chip):
    """The layout ``csrc/stencil_perks.cu`` takes for one-step plan ``p``
    in one CTA of ``chip``; None where every row is cached and
    ``csrc/stencil_resident.cu`` holds the domain (that kernel runs)."""
    shape = tuple(problem.x.shape)
    r, eb = problem.spec.radius, problem.x.element_size()
    limit = chip.smem_per_block - stencil2d.PERKS_STATIC_SMEM
    rows = p.cached_rows or 0
    if rows >= shape[0] and stencil2d.resident_layout(
            shape, r, eb, chip.sms, limit) is not None:
        return None
    return stencil2d.perks_layout(shape, r, eb, chip.sms, limit, rows)


def _tb_layout(problem, p: Plan, chip: Chip):
    """The layout the temporal-blocking kernel of plan ``p`` takes in one
    CTA of ``chip``."""
    return stencil2d.tb_layout(
        tuple(problem.x.shape), problem.spec.radius,
        min(p.fuse_steps, problem.n_steps), problem.x.element_size(),
        deep=p.schedule == "deep", ctas=chip.sms,
        limit=chip.smem_per_block - stencil2d.PERKS_STATIC_SMEM,
        cached_rows=p.cached_rows or 0)


def tb_compute_s(problem, p: Plan, *,
                 chip: Union[str, Chip] = "h100") -> float:
    """Seconds the levels of a temporal-blocking plan ``p`` cost whatever
    its bytes: each pass's ``shallow_pass_cost`` at ``TB_SHALLOW_TERM_S``
    a term (npoints + 1 a cell) or ``deep_pass_cost`` at
    ``TB_DEEP_LANE_CELL_S`` over the streamed rows (the last pass at
    ``n_steps % t`` levels), and the cached bands' ``band_pass_cost`` at
    ``TB_BAND_TERM_S`` a term."""
    shape, n = tuple(problem.x.shape), problem.n_steps
    chip = _as_chip(chip)
    lay = _tb_layout(problem, p, chip)
    t = min(p.fuse_steps, n)
    r = problem.spec.radius
    streamed = shape[0] - (p.cached_rows or 0)
    terms = problem.spec.npoints + 1
    deep = p.schedule == "deep"
    threads = stencil2d.PERKS_THREADS if deep else stencil2d.SHALLOW_THREADS
    bands = TB_BAND_TERM_S * terms * sum(
        stencil2d.band_pass_cost(shape, r, min(t, n - s), lay.maxband,
                                 threads)
        for s in range(0, n, t)) if lay.nb else 0.0
    if not deep:
        eb = problem.x.element_size()
        return bands + TB_SHALLOW_TERM_S * terms * sum(
            stencil2d.shallow_pass_cost(shape, r, min(t, n - s), eb,
                                        lay.strip, lay.rows, chip.sms,
                                        streamed)
            for s in range(0, n, t))
    cost = sum(stencil2d.deep_pass_cost(shape, r, min(t, n - s), lay.strip,
                                        lay.rows, chip.sms, streamed)
               for s in range(0, n, t))
    return bands + cost * TB_DEEP_LANE_CELL_S


def one_step_compute_s(problem, p: Plan, *,
                       chip: Union[str, Chip] = "h100") -> float:
    """Seconds a one-step resident plan ``p`` costs whatever its bytes:
    ``n_steps`` times a grid barrier (``RESIDENT_STEP_S``) and a CTA's work
    a term (npoints + 1 a cell) a thread: with every row cached in
    ``csrc/stencil_resident.cu``, ``stencil2d.resident_step_cost`` of
    ``resident_layout`` at ``RESIDENT_TERM_S``; else
    ``stencil2d.perks_step_cost`` of the one-step kernel's layout (its box
    and its strips' tile rows with their barriers) at ``PERKS_TERM_S``."""
    chip = _as_chip(chip)
    shape, n = tuple(problem.x.shape), problem.n_steps
    rows = p.cached_rows or 0
    r = problem.spec.radius
    terms = problem.spec.npoints + 1
    lay = _perks_layout(problem, p, chip)
    if lay is None and rows >= shape[0]:
        res = stencil2d.resident_layout(
            shape, r, problem.x.element_size(), chip.sms,
            chip.smem_per_block - stencil2d.PERKS_STATIC_SMEM)
        return n * (RESIDENT_STEP_S + stencil2d.resident_step_cost(res)
                    * terms * RESIDENT_TERM_S)
    work = 0.0 if lay is None else stencil2d.perks_step_cost(
        shape, r, lay, rows, chip.sms)
    return n * (RESIDENT_STEP_S + work * terms * PERKS_TERM_S)


def stencil_model_s(problem, p: Plan, *,
                    chip: Union[str, Chip] = "h100") -> tuple[float, str]:
    """Seconds the planner charges the kernel of resident stencil plan
    ``p`` (no dispatch) and what bounds it: the larger of its model bytes
    at the device-memory rate, the cached bytes through on-chip memory
    (Eq. 7) and its steps or levels (``one_step_compute_s``,
    ``tb_compute_s``)."""
    chip = _as_chip(chip)
    shape, n = tuple(problem.x.shape), problem.n_steps
    row_bytes = int(math.prod(shape[1:])) * problem.x.element_size()
    terms = {
        "main_memory": stencil_model_bytes(problem, p, chip=chip)
        / chip.hbm_bw,
        "onchip_memory": sm_bytes_accessed(
            n, (p.cached_rows or 0) * row_bytes) / chip.onchip_bw,
        "compute": (tb_compute_s(problem, p, chip=chip)
                    if _runs_tb(problem, p) else
                    one_step_compute_s(problem, p, chip=chip)
                    if p.tier == "resident" else 0.0),
    }
    bound_by = max(terms, key=terms.get)
    return terms[bound_by], bound_by


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


def _cg_lanes_fit(problem, chip: Chip, batch: int, matrix_rows: int) -> bool:
    """Whether ``csrc/cg_fused.cu`` holds ``batch`` right-hand sides of
    ``problem`` with ``matrix_rows`` rows of its A on chip, one CTA an SM of
    ``chip``: the wrapper's own layout (``cg_fused.smem_layout``, the lanes
    padded to the kernel's width) within a CTA's shared memory less the
    kernel's static shared memory, and at most ``cg_fused.MAX_LANES``
    lanes."""
    from repro_torch.kernels import cg_fused as kcg
    if batch > kcg.MAX_LANES:
        return False
    n, k = problem.data.shape
    smem = kcg.smem_layout(n, k, chip.sms, matrix_rows, batch)[2]
    return smem <= chip.smem_per_block - kcg.STATIC_SMEM_BYTES


def _cg_candidates(problem, chip: Chip, *,
                   sync_every: Optional[int], batch: int = 1,
                   runs=None, graph_kept: bool = False) -> list[Plan]:
    """The Krylov candidates of one instance ``problem``, priced for a
    batch of ``batch`` right-hand sides on its operator (``runs``: the
    problem that runs). The Krylov vectors scale by B (footprint and
    traffic), A does not: one resident copy serves every lane, and a
    batched SpMV streams A once an iteration for the whole batch. Launches
    are paid once a step for the batch; ``graph_kept`` prices the device
    loop as the replay of its kept graph."""
    from repro_torch.exec.adapters import fused_block_rows, plan_matrix_rows

    runs = problem if runs is None else runs
    arrays = [
        a if not problem.array_scales_with_batch(a.name) or batch == 1
        else dataclasses.replace(a, bytes=a.bytes * batch)
        for a in problem.cacheable_arrays()
    ]
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
    common = dict(n_steps=n, problem=runs.name, chip=chip.name,
                  sync_every=sync_every, batch=batch)
    launches = problem.step_launches()
    chunks = -(-n // sync_every) if sync_every and sync_every < n else 1
    # the device loop's launches: captured (with their first run) until
    # its graph is kept, then replayed
    launch_s = DISPATCH_OVERHEAD_S
    if chunks == 1 and (graph_kept or perks.graph_cached(
            runs.step_fn(), runs.initial_state(), n)):
        launch_s = GRAPH_LAUNCH_S
    cands = [
        Plan(tier="host_loop",
             predicted_s=n * (total_bytes / chip.hbm_bw
                              + launches * DISPATCH_OVERHEAD_S), **common),
        Plan(tier="device_loop", policy="IMP",
             predicted_s=n * (total_bytes / chip.hbm_bw + launches * launch_s)
             + chunks * DISPATCH_OVERHEAD_S, **common),
    ]
    kind = problem.kind
    rounds_s = n * krylov_round_s(problem)
    # a batch runs resident only where cg_fused's lanes hold it, with the
    # plan's rows of A (whether the family has a batched resident launch at
    # all is its batched_tiers(), the gate of plan_candidates)
    def lanes_fit(plan: Plan) -> bool:
        return batch == 1 or _cg_lanes_fit(
            problem, chip, batch,
            plan_matrix_rows(plan, problem.b.shape[0]))

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
                + rounds_s + DISPATCH_OVERHEAD_S, **common))
            if not lanes_fit(cands[-1]):
                cands.pop()
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
                + rounds_s + DISPATCH_OVERHEAD_S, **common))
            if not lanes_fit(cands[-1]):
                cands.pop()
    return cands


def _ml_candidates(problem, chip: Chip, *,
                   sync_every: Optional[int], batch: int = 1) -> list[Plan]:
    """Candidates for the ML problems (``exec/ml.py``), the reference's
    formulas for one instance: the loop tiers stream every
    ``cacheable_arrays`` byte each step, the resident tier all but the
    ``carry_names`` arrays' (kept on chip for the whole loop). Where the
    problem keeps its carry on chip on every tier
    (``carry_on_chip_every_tier``: the port's decode, whose every tier runs
    the flash-decode kernel), no tier is charged the carry. ``batch``
    prices B instances in one dispatch: per-instance arrays scale by B,
    the resident scratch must fit the per-instance budget
    (``batch.per_instance_chip``)."""
    from repro_torch.exec.batch import per_instance_chip

    arrays = [
        a if not problem.array_scales_with_batch(a.name) or batch == 1
        else dataclasses.replace(a, bytes=a.bytes * batch)
        for a in problem.cacheable_arrays()
    ]
    n = problem.n_steps
    carry_names = frozenset(getattr(problem, "carry_names", ()))
    total = sum(a.bytes * (a.loads_per_step + a.stores_per_step)
                for a in arrays)
    carry = sum(a.bytes * (a.loads_per_step + a.stores_per_step)
                for a in arrays if a.name in carry_names)
    carry_bytes = sum(a.bytes for a in arrays if a.name in carry_names)
    if getattr(problem, "carry_on_chip_every_tier", False):
        total -= carry
        carry = carry_bytes = 0.0
    has_sync = problem.on_sync() is not None
    if sync_every is None and has_sync and n > 1:
        # decode declares a convergence check (EOS); a short cadence, as
        # the reference's
        sync_every = min(8, max(1, n - 1))
    common = dict(n_steps=n, problem=problem.name, chip=chip.name,
                  sync_every=sync_every, batch=batch)
    cands = [
        Plan(tier="host_loop",
             predicted_s=n * (total / chip.hbm_bw + DISPATCH_OVERHEAD_S),
             predicted_bound="main_memory", **common),
        Plan(tier="device_loop",
             predicted_s=n * total / chip.hbm_bw + DISPATCH_OVERHEAD_S,
             predicted_bound="main_memory", **common),
    ]
    # RESIDENT: the whole loop in one fused program with the carry on chip;
    # never with a convergence check (it has no host-sync point)
    if (not has_sync and n > 0
            and problem.resident_scratch_bytes()
            <= per_instance_chip(chip, batch).onchip_bytes * 0.9):
        t_gm = n * max(0.0, total - carry) / chip.hbm_bw
        t_sm = sm_bytes_accessed(n, carry_bytes) / chip.onchip_bw
        cands.append(Plan(
            tier="resident", fuse_steps=max(1, n),
            cache=tuple(CacheDecision(a.name, a.bytes, a.bytes)
                        for a in arrays if a.name in carry_names),
            predicted_s=max(t_gm, t_sm) + DISPATCH_OVERHEAD_S,
            predicted_bound=("main_memory" if t_gm >= t_sm
                             else "onchip_memory"), **common))
    return cands


def plan_candidates(problem: Problem, *, chip: Union[str, Chip] = "h100",
                    max_fuse: int = 4, sub_rows: int = 128,
                    budget_bytes: Optional[int] = None,
                    sync_every: Optional[int] = None, batch: int = 1,
                    ledger=None) -> list[Plan]:
    """Every candidate Plan for ``problem``, ranked by projected time.
    Planning reads shapes only; it launches nothing. ``max_fuse`` caps the
    shallow stencil depth; ``budget_bytes`` replaces the card's on-chip
    capacity (the reference's proxy regimes); ``sync_every`` sets CG's
    host-check cadence.

    ``batch`` plans for B instances served by ONE dispatch
    (``repro_torch.exec.batch``): per-step traffic and per-instance
    on-chip budgets scale with B, launches and barriers do not. A
    :class:`~repro_torch.exec.batch.BatchedProblem` gives its own B. A
    batch is offered the tiers of the family's ``batched_tiers()`` only;
    a stencil batch's resident candidates are laid out for one lane's
    ``sms // B`` CTAs, and offered only where B is at most the SMs.

    ``ledger`` (default: the ambient ``repro_torch.obs.get_ledger()``)
    re-ranks with measured evidence: candidates the drift ledger has timed
    on this device with this torch outrank the projected ones, in order of
    their measured seconds."""
    return _candidates(problem, chip=chip, max_fuse=max_fuse,
                       sub_rows=sub_rows, budget_bytes=budget_bytes,
                       sync_every=sync_every, batch=batch, ledger=ledger)


def _candidates(problem: Problem, *, chip: Union[str, Chip] = "h100",
                max_fuse: int = 4, sub_rows: int = 128,
                budget_bytes: Optional[int] = None,
                sync_every: Optional[int] = None, batch: int = 1,
                ledger=None, graph_kept: bool = False) -> list[Plan]:
    """``plan_candidates``; with ``graph_kept`` a device loop is priced as
    the replay of its kept graph even where none is kept yet, for
    ``SolverService``, which runs every later batch of a key through the
    key's first runner and so pays the capture once."""
    from repro_torch import obs
    from repro_torch.exec.batch import BatchedProblem

    chip = _budget_chip(_as_chip(chip), budget_bytes)
    if max_fuse < 1:
        raise ValueError(f"max_fuse must be >= 1, got {max_fuse}")
    template = problem
    if isinstance(problem, BatchedProblem):
        if batch not in (1, problem.batch):
            raise ValueError(
                f"batch={batch} conflicts with problem.batch="
                f"{problem.batch}")
        batch = problem.batch
        template = problem.template
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if template.kind == "stencil":
        cands = _stencil_candidates(template, chip, sub_rows=sub_rows,
                                    max_fuse=max_fuse, batch=batch,
                                    runs=problem, graph_kept=graph_kept)
    elif template.kind in ("cg", "bicgstab", "gmres"):
        cands = _cg_candidates(template, chip, sync_every=sync_every,
                               batch=batch, runs=problem,
                               graph_kept=graph_kept)
    elif template.kind in ("decode", "ssm"):
        cands = _ml_candidates(template, chip, sync_every=sync_every,
                               batch=batch)
    else:
        raise NotImplementedError(
            f"no candidate generator for problem kind {template.kind!r}")
    # the one gate of what a batch runs: its family's batched tiers
    supports = (problem.supports if batch == 1 else
                (lambda tier: tier in template.batched_tiers()))
    cands = _rank([c for c in cands if supports(c.tier)])
    if ledger is None:
        ledger = obs.get_ledger()
    if ledger is not None:
        cands = ledger.rerank(problem, cands)
    tr = obs.get_tracer()
    if tr.enabled and cands:
        tr.event(f"plan:{problem.name}", cat="plan", track="planner",
                 n_candidates=len(cands), best_tier=cands[0].tier,
                 best_predicted_s=cands[0].predicted_s, batch=batch)
    return cands


def plan(problem: Problem, *, chip: Union[str, Chip] = "h100",
         max_fuse: int = 4, sub_rows: int = 128,
         budget_bytes: Optional[int] = None,
         sync_every: Optional[int] = None, batch: int = 1,
         ledger=None) -> Plan:
    """The planner's top candidate for ``problem``: the lowest measured
    time where the drift ledger has evidence, the lowest projected time
    otherwise."""
    return plan_candidates(problem, chip=chip, max_fuse=max_fuse,
                           sub_rows=sub_rows,
                           budget_bytes=budget_bytes,
                           sync_every=sync_every, batch=batch,
                           ledger=ledger)[0]


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
