"""Resident stencil plans fitted to what the card's kernels hold
(``exec.adapters.fit_stencil_plan``, called by
``StencilProblem.run_resident``), on the H100's data-sheet limits.

The JAX package plans for a TPU's memory; some of its plans ask for more
cached rows, or deeper temporal blocking beside them, than one CTA of the
H100 holds. Such a plan takes fewer cached rows, then a shallower depth
where no band fits, with one ``RuntimeWarning``; every kernel gives the
same bits, so the result is still the reference's.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.common import BENCHMARKS as JAX_SPECS
from repro_torch.core import hardware as thw
from repro_torch.exec import Plan, StencilProblem, execute
from repro_torch.exec.adapters import fit_stencil_plan
from repro_torch.kernels import stencil2d
from repro_torch.kernels.common import get_spec

H100 = thw.H100
LIMIT = H100.smem_per_block - stencil2d.PERKS_STATIC_SMEM
ATOL = 5e-6

# The JAX package's plans (``Plan.to_json``) that the H100 cannot hold as
# they are, as chip_smoke.py keeps them: deep t = 8 with 1240 cached rows of
# 2d5pt 8192^2, and shallow t = 4 with 176 cached planes of 3d27pt 256^3.
DEEP_1240 = (
    '{"tier": "resident", "n_steps": 100, "problem": "stencil_2d5pt", '
    '"chip": "tpu_v5e", "batch": 1, "fuse_steps": 8, "schedule": "deep", '
    '"sync_every": null, "cache": [{"name": "domain_rows", "cached_bytes": '
    '40632320, "total_bytes": 268435456}], "cached_rows": 1240, '
    '"sub_rows": 128, "policy": null, "block_rows": null, "shard_axis": '
    'null, "partition": "rows", "fuse_reductions": false, "s_step": 1, '
    '"inner_tier": "device_loop", "precision": "uniform", "predicted_s": '
    'null, "predicted_bound": null}')
SHALLOW_176 = (
    '{"tier": "resident", "n_steps": 100, "problem": "stencil_3d27pt", '
    '"chip": "tpu_v5e", "batch": 1, "fuse_steps": 4, "schedule": '
    '"shallow", "sync_every": null, "cache": [{"name": "domain_rows", '
    '"cached_bytes": 46137344, "total_bytes": 67108864}], "cached_rows": '
    '176, "sub_rows": 128, "policy": null, "block_rows": null, '
    '"shard_axis": null, "partition": "rows", "fuse_reductions": false, '
    '"s_step": 1, "inner_tier": "device_loop", "precision": "uniform", '
    '"predicted_s": null, "predicted_bound": null}')
REFERENCE = [(DEEP_1240, "2d5pt", (8192, 8192)),
             (SHALLOW_176, "3d27pt", (256, 256, 256))]


def _holds(shape, spec, p, eb=4):
    """Whether the kernel the plan runs holds its layout in one CTA."""
    r = spec.radius
    R, t = p.cached_rows, min(p.fuse_steps, p.n_steps)
    if R >= shape[0]:
        return (stencil2d.resident_layout(shape, r, eb, H100.sms, LIMIT)
                is not None or stencil2d.perks_layout(
                    shape, r, eb, H100.sms, LIMIT, R) is not None)
    if p.schedule == "shallow" and t == 1:
        lay = stencil2d.perks_layout(shape, r, eb, H100.sms, LIMIT, R)
    else:
        lay = stencil2d.tb_layout(shape, r, t, eb,
                                  deep=p.schedule == "deep", ctas=H100.sms,
                                  limit=LIMIT, cached_rows=R)
    return lay is not None and lay.smem <= LIMIT


@pytest.mark.parametrize("text,name,shape", REFERENCE)
def test_reference_plans_are_fitted_to_a_layout_the_kernels_hold(text, name,
                                                                 shape):
    """Neither reference plan holds as it is; the fitted one does, with
    fewer cached rows (a shallower depth of the same schedule where no
    band fits at the plan's), and the message names both."""
    spec = get_spec(name)
    p = Plan.from_json(text)
    assert not _holds(shape, spec, p)
    got, why = fit_stencil_plan(shape, 4, spec, p, H100)
    assert why is not None and str(p.cached_rows) in why
    assert f"t={got.fuse_steps}" in why and str(got.cached_rows) in why
    assert _holds(shape, spec, got)
    assert got.cached_rows < p.cached_rows
    assert got.fuse_steps <= p.fuse_steps
    assert got.schedule == p.schedule
    got.validate(radius=spec.radius, domain_rows=shape[0])
    assert got.cache[0].cached_bytes == got.cached_rows * int(
        np.prod(shape[1:])) * 4
    assert fit_stencil_plan(shape, 4, spec, got, H100) == (got, None)


def test_deep_plan_takes_the_deepest_depth_with_a_band():
    """deep t = 8 with 1240 rows of 8192 f32 columns: no band of 2rt + r +
    1 rows fits at t = 8 or 4; t = 2 holds bands of 2 rows."""
    p = Plan.from_json(DEEP_1240)
    got, _ = fit_stencil_plan((8192, 8192), 4, get_spec("2d5pt"), p, H100)
    assert (got.schedule, got.fuse_steps) == ("deep", 2)
    assert 0 < got.cached_rows <= 1240
    for t in (8, 4):
        assert stencil2d.tb_layout((8192, 8192), 1, t, 4, deep=True,
                                   ctas=H100.sms, limit=LIMIT,
                                   cached_rows=1) is None


def test_wide_planes_take_the_one_step_kernels_boxes():
    """3d27pt 256^3 at t = 4: 256^2 planes are wider than the
    temporal-blocking bands hold, at t = 4 and 2; the one-step kernel
    caches them in boxes."""
    p = Plan.from_json(SHALLOW_176)
    got, _ = fit_stencil_plan((256, 256, 256), 4, get_spec("3d27pt"), p, H100)
    assert (got.schedule, got.fuse_steps) == ("shallow", 1)
    lay = stencil2d.perks_layout((256, 256, 256), 1, 4, H100.sms, LIMIT,
                                 got.cached_rows)
    assert lay is not None and lay.nby > 1 and got.cached_rows > 0


@pytest.mark.parametrize("name,shape,plan", [
    ("2d5pt", (40, 8192), dict(schedule="deep", fuse_steps=8,
                               cached_rows=30)),
    ("3d27pt", (20, 160, 160), dict(schedule="shallow", fuse_steps=4,
                                    cached_rows=16)),
    ("2d5pt", (700, 8192), dict(schedule="shallow", fuse_steps=1,
                                cached_rows=690)),
])
def test_small_plans_the_card_cannot_hold_run_and_warn_once(name, shape,
                                                            plan):
    """Small domains as wide as the reference plans': execute on the CPU
    fits the plan with one RuntimeWarning and equals the JAX package's
    plain run at its kernel bound."""
    spec = get_spec(name)
    steps = 6
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    p = Plan(tier="resident", n_steps=steps, sub_rows=128, **plan)
    assert not _holds(shape, spec, p)
    problem = StencilProblem(x, spec, steps, device="cpu")
    with pytest.warns(RuntimeWarning, match="does not fit") as rec:
        got = execute(problem, p)
    assert len([w for w in rec if w.category is RuntimeWarning]) == 1
    want = jref.stencil_run(jnp.asarray(x), JAX_SPECS[name], steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("name,shape,plan", [
    ("2d5pt", (8192, 8192), dict(schedule="shallow", fuse_steps=4,
                                 cached_rows=0)),
    ("2d5pt", (3072, 1152), dict(schedule="shallow", fuse_steps=1,
                                 cached_rows=3072)),
    ("2d5pt", (8192, 8192), dict(schedule="deep", fuse_steps=8,
                                 cached_rows=0)),
    ("3d7pt", (256, 256, 256), dict(schedule="shallow", fuse_steps=2,
                                    cached_rows=0)),
])
def test_plans_that_fit_pass_unchanged(name, shape, plan):
    p = Plan(tier="resident", n_steps=100, **plan)
    assert fit_stencil_plan(shape, 4, get_spec(name), p, H100) == (p, None)


def test_a_small_plan_that_fits_runs_without_a_warning():
    spec = get_spec("2d5pt")
    x = np.random.default_rng(2).standard_normal((64, 96)).astype(np.float32)
    problem = StencilProblem(x, spec, 5, device="cpu")
    p = Plan(tier="resident", n_steps=5, fuse_steps=1, cached_rows=12)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = execute(problem, p)
    assert torch.equal(got, problem.oracle())
