"""The port's deep temporal blocking and its planning against the JAX
reference: ``stencil_perks_deep`` at t = 2, 3, 8 on all 13 Table-III
specs, the byte models, the H100 planner's temporally blocked candidates,
reference plans with ``fuse_steps>1`` and ``schedule="deep"``, and bf16.

Inputs are made with numpy from a seed and handed to both packages. The
JAX kernels run as ``tests/test_deep_blocking.py`` runs them on the CPU
(Pallas interpret mode); the port's wrappers run their plain torch
versions because the tensors lie on the CPU. Bounds: the reference's, atol
5e-6 with rtol 0 for float32 and 2e-2 for bf16
(``tests/test_kernels_stencil.py``). The bf16 rounding differs between the
packages by design: the reference's ``w * x`` rounds w to bf16 first (jnp's
weak typing), torch multiplies in float32 and rounds the product once. The
CUDA kernel (``csrc/stencil_tb.cu``) is held to the port's plain version on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import cache_policy as jcp
from repro.exec import Plan as JaxPlan
from repro.exec import StencilProblem as JaxStencilProblem
from repro.exec import execute as jax_execute
from repro.exec import plan_candidates as jax_plan_candidates
from repro.kernels import stencil2d as jk
from repro.kernels.common import BENCHMARKS as JAX_SPECS
from repro_torch.convert import plan_from_reference
from repro_torch.core import cache_policy as tcp
from repro_torch.core import hardware as thw
from repro_torch.exec import StencilProblem, execute, plan_candidates
from repro_torch.kernels import ops, stencil2d
from repro_torch.kernels.common import BENCHMARKS, get_spec
from repro_torch.kernels.stencil3d import plan_resident_planes

ATOL = 5e-6
BF16_ATOL = 2e-2
NAMES = sorted(BENCHMARKS)
STEPS = 11


def _domain(spec, seed=0, shape=None):
    shape = shape or ((48, 64) if spec.ndim == 2 else (24, 16, 32))
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- the deep kernel over the whole zoo ----------------------------------------

@pytest.mark.parametrize("t", [2, 3, 8])
@pytest.mark.parametrize("cached", ["none", "4r+1"])
@pytest.mark.parametrize("name", NAMES)
def test_deep_stencil_perks_matches_reference(name, cached, t):
    spec = get_spec(name)
    r = spec.radius
    x = _domain(spec, seed=t)
    H = x.shape[0]
    rows = 0 if cached == "none" else 4 * r + 1
    sub = 9 if (H - rows) % 9 else 10          # a ragged last block
    want = jk.stencil_perks_deep(jnp.asarray(x), JAX_SPECS[name],
                                 steps=STEPS, cached_rows=rows, sub_rows=sub,
                                 fuse_steps=t)
    xt = torch.from_numpy(x)
    got = ops.stencil_perks_deep(xt, spec=spec, steps=STEPS,
                                 cached_rows=rows, sub_rows=sub,
                                 fuse_steps=t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert np.array_equal(xt.numpy(), x), "the input must not be written"


def test_deep_preconditions_raise():
    spec = get_spec("2ds25pt")                      # radius 6
    x = torch.from_numpy(_domain(spec))
    with pytest.raises(ValueError, match="sub_rows >= radius = 6"):
        ops.stencil_perks_deep(x, spec=spec, steps=4, cached_rows=0,
                               sub_rows=5, fuse_steps=32)
    with pytest.raises(ValueError, match="partial caching"):
        ops.stencil_perks_deep(x, spec=spec, steps=4, cached_rows=3)
    with pytest.raises(ValueError, match="fuse_steps"):
        ops.stencil_perks_deep(x, spec=spec, steps=4, cached_rows=0,
                               fuse_steps=0)
    # sub_rows >= radius is all the deep schedule asks, at any depth
    ops.stencil_perks_deep(x, spec=spec, steps=4, cached_rows=0, sub_rows=6,
                           fuse_steps=32)
    before = ops.launch_counts()
    ops.stencil_perks_deep(x, spec=spec, steps=2, cached_rows=0)
    assert ops.launch_counts() == before, "a CPU tensor launches nothing"


# -- byte models -----------------------------------------------------------------

_GRID = list(itertools.product((1, 7, 100), (1, 2, 3, 8, 32), (0.0, 0.3, 1.0)))


def test_deep_byte_model_and_scratch_match_reference():
    dom = 97 * 4096
    for n, t, frac in _GRID:
        cached = int(frac * dom)
        assert tcp.gm_bytes_deep(n, dom, cached, fuse_steps=t) == \
            jcp.gm_bytes_deep(n, dom, cached, fuse_steps=t)
    for sub, r, t in itertools.product((1, 8, 128), (1, 2, 6), (1, 4, 32)):
        assert tcp.deep_scratch_rows(sub, r, t) == \
            jcp.deep_scratch_rows(sub, r, t)


@pytest.mark.parametrize("shape", [(48, 64), (8192, 8192), (24, 16, 32),
                                   (256, 256, 256)])
def test_port_byte_model_is_never_below_the_least(shape):
    """The port's model of its kernel (halo re-reads included) against
    gm_bytes_deep at the same cached rows, for both schedules and every
    layout the kernel takes."""
    h100 = thw.H100
    limit = h100.smem_per_block - stencil2d.PERKS_STATIC_SMEM
    row = int(np.prod(shape[1:])) * 4
    for r, t, deep, n in itertools.product((1, 2), (2, 3, 8), (False, True),
                                           (1, 11, 100)):
        rows = stencil2d.tb_cached_rows(shape, r, t, 4, deep=deep,
                                        ctas=h100.sms, limit=limit)
        if rows is None:
            continue
        lay = stencil2d.tb_layout(shape, r, t, 4, deep=deep, ctas=h100.sms,
                                  limit=limit, cached_rows=rows)
        got = tcp.gm_bytes_tb(n, shape, 4, radius=r, fuse_steps=t,
                              cached_rows=rows, bands=lay.nb,
                              strip=lay.strip, rows=lay.rows, deep=deep)
        least = tcp.gm_bytes_deep(n, shape[0] * row, rows * row, fuse_steps=t)
        assert got >= least, (shape, r, t, deep, n)
    # 2 passes of a 4-row 2D domain, one 4x4 tile, nothing cached: each
    # pass reads and writes the 16 cells once
    assert tcp.gm_bytes_tb(4, (4, 4), 4, radius=1, fuse_steps=2,
                           cached_rows=0, bands=0, strip=(1, 4), rows=4,
                           deep=False) == 2 * 2 * 16 * 4


# -- the H100 planner -----------------------------------------------------------

def _meta(shape, n, name, dtype=torch.float32):
    return StencilProblem(torch.empty(shape, device="meta", dtype=dtype),
                          get_spec(name), n, device="meta")


@pytest.mark.parametrize("shape,n,name,dtype", [
    ((8192, 8192), 100, "2d5pt", torch.float32),
    ((3072, 1152), 1000, "2d5pt", torch.float32),
    ((160, 160, 128), 50, "3d7pt", torch.float32),
    ((4096, 2048), 100, "2ds25pt", torch.bfloat16),
])
def test_planner_offers_fitting_shallow_and_deep_candidates(shape, n, name,
                                                            dtype):
    h100 = thw.H100
    limit = h100.smem_per_block - stencil2d.PERKS_STATIC_SMEM
    spec = get_spec(name)
    eb = torch.empty((), dtype=dtype).element_size()
    cands = plan_candidates(_meta(shape, n, name, dtype), chip=h100)
    res = [c for c in cands if c.tier == "resident"]
    assert {c.schedule for c in res if c.fuse_steps > 1} == {"shallow",
                                                             "deep"}
    for c in res:
        if c.fuse_steps == 1 and c.schedule == "shallow":
            lay = (stencil2d.resident_layout(shape, spec.radius, eb,
                                             h100.sms, limit)
                   if c.cached_rows == shape[0] else None)
            lay = lay or stencil2d.perks_layout(shape, spec.radius, eb,
                                                h100.sms, limit,
                                                c.cached_rows)
            assert lay is not None, c
            need = lay.smem
        else:
            lay = stencil2d.tb_layout(shape, spec.radius, c.fuse_steps, eb,
                                      deep=c.schedule == "deep",
                                      ctas=h100.sms, limit=limit,
                                      cached_rows=c.cached_rows)
            assert lay is not None, c
            need = lay.smem
        assert need <= limit, c
        assert c.cached_rows == plan_resident_planes(
            shape, eb, spec, chip=h100, fuse_steps=c.fuse_steps,
            schedule=c.schedule)
        c.validate(radius=spec.radius, domain_rows=shape[0])
    assert cands == sorted(cands, key=lambda c: (c.predicted_s, c.barriers,
                                                 -c.cached_bytes))


@pytest.mark.parametrize("shape,n,name,dtype,pick", [
    ((8192, 8192), 100, "2d5pt", torch.float32,
     ("resident", "shallow", 4, 0)),
    ((3072, 1152), 1000, "2d5pt", torch.float32,
     ("resident", "shallow", 1, 3072)),
    ((256, 256, 256), 100, "3d7pt", torch.float32,
     ("host_loop", "shallow", 1, None)),
    ((4096, 2048), 100, "2ds25pt", torch.bfloat16,
     ("host_loop", "shallow", 1, None)),
])
def test_planner_charges_temporal_blocking_its_levels(shape, n, name, dtype,
                                                      pick):
    """A candidate that runs a temporal-blocking kernel is priced at its
    byte model (gm_bytes_tb at the kernel's layout) and at least its
    levels' measured price: its cached bands' band_pass_cost at
    TB_BAND_TERM_S a term and, shallow, TB_SHALLOW_TERM_S a term of
    shallow_pass_cost, at least every streamed cell-step over every CTA's
    threads; deep, at least the streamed cell-steps over the lanes of
    every CTA's level warps at TB_DEEP_LANE_CELL_S. The one-step plans keep
    Eq. 5 and are charged at least their steps (one_step_compute_s), and
    with rows streamed every CTA's share of them at PERKS_TERM_S, bytes
    by the one-step kernel's own model (gm_bytes_perks). The
    pick, (tier, schedule, depth, cached rows): on stencil large the
    shallow tiles at t = 4 (13.1 ms measured, the one-step kernel 30.3),
    on stencil small the whole domain cached (10.3 ms, the kept device
    loop 16.0); on 3d7pt 256^3 no longer the one-step kernel (12.6 ms,
    shallow t = 2 8.6; PERF.md)."""
    from repro_torch.exec import plan, planner
    h100 = thw.H100
    limit = h100.smem_per_block - stencil2d.PERKS_STATIC_SMEM
    spec = get_spec(name)
    problem = _meta(shape, n, name, dtype)
    eb = problem.x.element_size()
    row = int(np.prod(shape[1:])) * eb
    terms = spec.npoints + 1
    for c in plan_candidates(problem, chip=h100):
        if c.tier != "resident":
            continue
        secs, by = planner.stencil_model_s(problem, c, chip=h100)
        assert c.predicted_s == pytest.approx(
            secs + planner.DISPATCH_OVERHEAD_S)
        assert c.predicted_bound == by
        got = planner.stencil_model_bytes(problem, c, chip=h100)
        streamed = (shape[0] - c.cached_rows) * row // eb
        if c.cached_rows < shape[0] and (c.schedule == "deep"
                                         or c.fuse_steps > 1):
            lay = stencil2d.tb_layout(shape, spec.radius, c.fuse_steps, eb,
                                      deep=c.schedule == "deep",
                                      ctas=h100.sms, limit=limit,
                                      cached_rows=c.cached_rows)
            assert got == tcp.gm_bytes_tb(
                n, shape, eb, radius=spec.radius, fuse_steps=c.fuse_steps,
                cached_rows=c.cached_rows, bands=lay.nb, strip=lay.strip,
                rows=lay.rows, deep=c.schedule == "deep")
            levels = planner.tb_compute_s(problem, c, chip=h100)
            t = c.fuse_steps
            threads = (stencil2d.PERKS_THREADS if c.schedule == "deep"
                       else stencil2d.SHALLOW_THREADS)
            bands = planner.TB_BAND_TERM_S * terms * sum(
                stencil2d.band_pass_cost(shape, spec.radius, min(t, n - s),
                                         lay.maxband, threads)
                for s in range(0, n, t)) if lay.nb else 0.0
            assert levels >= bands
            if c.schedule == "deep":
                lanes = h100.sms * 32 * stencil2d.DEEP_WARPS
                assert levels >= (streamed * n / lanes
                                  * planner.TB_DEEP_LANE_CELL_S)
            else:
                assert levels == pytest.approx(
                    bands + planner.TB_SHALLOW_TERM_S * terms * sum(
                        stencil2d.shallow_pass_cost(
                            shape, spec.radius, min(t, n - s), eb,
                            lay.strip, lay.rows, h100.sms,
                            shape[0] - c.cached_rows)
                        for s in range(0, n, t)))
                threads = h100.sms * stencil2d.SHALLOW_THREADS
                assert levels >= (streamed * n / threads * terms
                                  * planner.TB_SHALLOW_TERM_S)
            assert secs >= levels
        else:
            res = stencil2d.resident_layout(shape, spec.radius, eb, h100.sms,
                                            limit)
            if c.cached_rows == shape[0] and res is not None:
                assert got == tcp.gm_bytes_fused(
                    n, shape[0] * row, c.cached_rows * row, row_bytes=row,
                    radius=spec.radius, fuse_steps=1)
            else:
                lay = stencil2d.perks_layout(shape, spec.radius, eb,
                                             h100.sms, limit, c.cached_rows)
                assert got == tcp.gm_bytes_perks(
                    n, shape, eb, radius=spec.radius,
                    cached_rows=c.cached_rows, boxes=(lay.nbz, lay.nby),
                    strip=lay.strip, left=lay.window[0], strips=lay.nseg)
                # Eq. 5 and the halos: never below the streamed rows read
                # and written every step
                assert got >= 2 * n * streamed * eb
            steps = planner.one_step_compute_s(problem, c, chip=h100)
            assert steps >= n * planner.RESIDENT_STEP_S
            if c.cached_rows < shape[0]:
                assert steps >= n * (streamed / h100.sms
                                     / stencil2d.STREAM_THREADS * terms
                                     * planner.PERKS_TERM_S)
            assert secs >= steps
    best = plan(problem, chip=h100)
    assert (best.tier, best.schedule, best.fuse_steps,
            best.cached_rows) == pick


@pytest.mark.parametrize("shape,name,deep_t,deeper_t", [
    ((8192, 8192), "2d5pt", 8, 32),
    ((256, 256, 256), "3d7pt", 8, 16),
])
def test_planner_prices_deep_levels_by_depth(shape, name, deep_t, deeper_t):
    """The deep levels' price follows the layout of each depth: the
    deepest candidate is not the cheapest where the sweep measured it
    slowest (2d5pt 8192^2 t = 32 against t = 8), and 3d7pt 256^3 at t = 16,
    whose strips are mostly side halo, costs several times t = 8."""
    from repro_torch.exec import planner
    h100 = thw.H100
    problem = _meta(shape, 100, name, torch.float32)
    deep = {c.fuse_steps: c for c in plan_candidates(problem, chip=h100)
            if c.tier == "resident" and c.schedule == "deep"}
    price = {t: planner.tb_compute_s(problem, c, chip=h100)
             for t, c in deep.items()}
    assert price[deeper_t] > price[deep_t]
    assert min(price, key=price.get) != max(price)
    if len(shape) == 3:
        assert price[deeper_t] > 4 * price[deep_t]


def test_plan_resident_planes_doubles_for_bf16():
    from repro_torch.kernels.stencil2d import rows_per_cta
    h100 = thw.H100
    limit = h100.smem_per_block - stencil2d.PERKS_STATIC_SMEM
    spec = get_spec("2d5pt")
    # 8192 cells: 7 f32 rows or 14 bf16 rows a CTA, less the r-row shift;
    # beside the streamed rows' window (stencil2d.perks_window: 8 rows of
    # 920 f32 or 1384 bf16 columns) 6 f32 or 12 bf16 rows, less the shift
    assert rows_per_cta(8192, 4, 1, limit) == 6
    assert rows_per_cta(8192, 2, 1, limit) == 13
    win4 = stencil2d.perks_window((8192, 8192), 1, 4)[4]
    win2 = stencil2d.perks_window((8192, 8192), 1, 2)[4]
    assert rows_per_cta(8192, 4, 1, limit, win4) == 5
    assert rows_per_cta(8192, 2, 1, limit, win2) == 11
    assert plan_resident_planes((8192, 8192), 2, spec, chip=h100) == 132 * 11
    assert plan_resident_planes((8192, 8192), 4, spec, chip=h100) == 132 * 5
    # with temporal blocking a band takes half a CTA beside its 2rt halo
    # rows: none at f32, (7 - 4 - 1) rows a CTA at bf16 and t = 2
    assert plan_resident_planes((8192, 8192), 4, spec, chip=h100,
                                fuse_steps=2) == 0
    assert plan_resident_planes((8192, 8192), 2, spec, chip=h100,
                                fuse_steps=2) == 132 * 2
    with pytest.raises(ValueError, match="schedule"):
        plan_resident_planes((64, 64), 4, spec, chip=h100, schedule="wide")


# -- reference plans with temporal blocking run in the port ---------------------

@pytest.mark.parametrize("name", ["2d5pt", "2ds25pt", "3d13pt"])
def test_reference_fused_and_deep_plans_execute(name):
    spec = get_spec(name)
    x = _domain(spec, seed=3)
    jp = JaxStencilProblem(jnp.asarray(x), JAX_SPECS[name], 9)
    tp = StencilProblem(x, spec, 9, device="cpu")
    jcands = jax_plan_candidates(jp, max_fuse=4)
    picked = [next(c for c in jcands if c.tier == "resident"
                   and c.schedule == "shallow" and c.fuse_steps > 1),
              next(c for c in jcands if c.tier == "resident"
                   and c.schedule == "deep"),
              JaxPlan(tier="resident", schedule="deep", fuse_steps=8,
                      cached_rows=4 * spec.radius + 1, sub_rows=9,
                      n_steps=9)]
    for jplan in picked:
        tplan = plan_from_reference(jplan.to_json())
        assert tplan.fuse_steps == jplan.fuse_steps > 1
        assert tplan.schedule == jplan.schedule
        got = execute(tp, tplan)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jax_execute(jp, jplan)),
                                   rtol=0, atol=ATOL)
        assert torch.equal(got, tp.oracle())


# -- bf16 ------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_bf16_plain_versions_match_reference(name):
    spec = get_spec(name)
    x = torch.from_numpy(_domain(spec, seed=5)).to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)   # same values
    jspec = JAX_SPECS[name]
    r = spec.radius
    cases = [
        (ops.stencil_resident(x, spec=spec, steps=4),
         jk.stencil_resident(xj, jspec, steps=4)),
        (ops.stencil_baseline_step(x, spec=spec),
         jk.stencil_baseline_step(xj, jspec, sub_rows=8)),
        (ops.stencil_perks(x, spec=spec, steps=4, cached_rows=4 * r + 1,
                           sub_rows=8),
         jk.stencil_perks(xj, jspec, steps=4, cached_rows=4 * r + 1,
                          sub_rows=8)),
        (ops.stencil_perks(x, spec=spec, steps=5, cached_rows=0,
                           sub_rows=2 * r, fuse_steps=2),
         jk.stencil_perks(xj, jspec, steps=5, cached_rows=0, sub_rows=2 * r,
                          fuse_steps=2)),
        (ops.stencil_perks_deep(x, spec=spec, steps=5, cached_rows=4 * r + 1,
                                sub_rows=9, fuse_steps=4),
         jk.stencil_perks_deep(xj, jspec, steps=5, cached_rows=4 * r + 1,
                               sub_rows=9, fuse_steps=4)),
    ]
    for got, want in cases:
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=BF16_ATOL)
