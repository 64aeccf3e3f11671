"""The port's executor slice against the JAX reference: Plan JSON in both
directions, ``execute`` on every single-device tier, the cache policy and
performance model, and the H100 planner.

Inputs are made with numpy from a seed and handed to both packages. Within
the port the tiers agree bit for bit (they run one step function, or the
same arithmetic in the same order); across packages they agree at the
reference's kernel bound, atol 5e-6 with rtol 0.
"""
import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import cache_policy as jcp
from repro.core import hardware as jhw
from repro.core import perf_model as jpm
from repro.exec import Plan as JaxPlan
from repro.exec import StencilProblem as JaxStencilProblem
from repro.exec import execute as jax_execute
from repro.exec import operand_fingerprint as jax_fingerprint
from repro.kernels.common import BENCHMARKS as JAX_SPECS
from repro_torch.convert import domain_from_numpy, plan_from_reference
from repro_torch.core import cache_policy as tcp
from repro_torch.core import hardware as thw
from repro_torch.core import perf_model as tpm
from repro_torch.core import perks
from repro_torch.exec import (CacheDecision, Plan, StencilProblem, execute,
                              fusion_schedule, operand_fingerprint, plan,
                              plan_candidates)
from repro_torch.kernels.common import BENCHMARKS, get_spec

ATOL = 5e-6
NAMES = sorted(BENCHMARKS)
STEPS = 5


def _domain(spec, seed=0):
    shape = (32, 40) if spec.ndim == 2 else (20, 14, 18)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- Plan JSON ----------------------------------------------------------------

_PLANS = [
    dict(tier="host_loop", chip="h100"),
    dict(tier="device_loop", n_steps=9, sync_every=4, problem="stencil_2d5pt",
         chip="tpu_v5e"),
    dict(tier="resident", cached_rows=24, sub_rows=8, fuse_steps=2, chip="h100",
         predicted_s=1.5e-4, predicted_bound="main_memory",
         cache=(("domain_rows", 3840, 5120),)),
    dict(tier="resident", schedule="deep", fuse_steps=8, cached_rows=0,
         chip="tpu_v5e"),
    dict(tier="distributed", shard_axis="data", fuse_steps=2, s_step=1,
         inner_tier="host_loop", partition="nnz", policy="MIX",
         block_rows=256, fuse_reductions=True, precision="mixed", batch=4,
         chip="h100"),
]


def _cache(kw, cls):
    kw = dict(kw)
    kw["cache"] = tuple(cls(*c) for c in kw.get("cache", ()))
    return kw


@pytest.mark.parametrize("i", range(len(_PLANS)))
def test_plan_json_round_trips_both_ways(i):
    from repro.exec.plan import CacheDecision as JaxCacheDecision
    jp = JaxPlan(**_cache(_PLANS[i], JaxCacheDecision))
    tp = Plan.from_json(jp.to_json())
    assert tp == Plan(**_cache(_PLANS[i], CacheDecision))
    assert plan_from_reference(jp.to_json()) == tp
    assert plan_from_reference(jp.to_dict()) == tp
    assert JaxPlan.from_json(tp.to_json()) == jp
    assert json.loads(tp.to_json()) == json.loads(jp.to_json())


def test_plan_schema_fields_match():
    assert Plan.__dataclass_fields__.keys() == JaxPlan.__dataclass_fields__.keys()
    with pytest.raises(ValueError, match="unknown Plan fields"):
        Plan.from_dict({"tier": "host_loop", "vmem": 1})


# -- execute on every tier ------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_execute_tiers_match_reference(name):
    spec = get_spec(name)
    x = _domain(spec, seed=5)
    H = x.shape[0]
    jp = JaxStencilProblem(jnp.asarray(x), JAX_SPECS[name], STEPS)
    tp = StencilProblem(x, spec, STEPS, device="cpu")
    plans = [JaxPlan(tier="host_loop"), JaxPlan(tier="device_loop"),
             JaxPlan(tier="resident", cached_rows=H),
             JaxPlan(tier="resident", cached_rows=max(spec.radius, H // 2),
                     sub_rows=8)]
    outs = []
    for p in plans:
        got = execute(tp, plan_from_reference(p.to_json()))
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_execute(jp, p)),
                                   rtol=0, atol=ATOL)
        outs.append(got)
    for got in outs[1:]:
        assert torch.equal(got, outs[0])
    assert np.array_equal(tp.x.numpy(), x), "the input must not be written"


def test_loop_combinators_agree_bit_for_bit():
    spec = get_spec("2d9pt")
    x = torch.from_numpy(_domain(spec, seed=6))
    step = StencilProblem(x, spec, 7, device="cpu").step_fn()
    host = perks.host_loop(step, 7)(x)
    for runner in (perks.device_loop(step, 7),
                   perks.chunked_loop(step, 7, sync_every=3),
                   perks.persistent(step, 7, perks.PerksConfig(
                       execution=perks.Execution.HOST_LOOP, fuse_steps=2)),
                   perks.persistent(step, 7, perks.PerksConfig(sync_every=2))):
        assert torch.equal(runner(x), host)
    assert torch.equal(perks.host_loop(step, 0)(x), x)


def test_host_loop_stops_at_on_sync():
    spec = get_spec("2d5pt")
    x = torch.from_numpy(_domain(spec, seed=7))
    step = StencilProblem(x, spec, 9, device="cpu").step_fn()
    seen = []
    out = perks.host_loop(step, 9, on_sync=lambda s, k: seen.append(k) or k == 3)(x)
    assert seen == [1, 2, 3]
    assert torch.equal(out, perks.host_loop(step, 3)(x))
    seen.clear()
    perks.chunked_loop(step, 9, sync_every=4,
                       on_sync=lambda s, k: seen.append(k) or False)(x)
    assert seen == [4, 8, 9]


def test_execute_rejects_what_is_not_ported():
    spec = get_spec("2d5pt")
    p = StencilProblem(_domain(spec), spec, 3, device="cpu")
    # the deep schedule is ported: it runs
    assert torch.equal(execute(p, Plan(tier="resident", schedule="deep",
                                       cached_rows=8, fuse_steps=2,
                                       sub_rows=8)), p.oracle())
    with pytest.raises(NotImplementedError, match="distributed"):
        execute(p, Plan(tier="distributed", shard_axis="data"))
    with pytest.raises(ValueError, match="n_steps"):
        execute(p, Plan(tier="host_loop", n_steps=4))
    with pytest.raises(ValueError, match="cached_rows"):
        execute(p, Plan(tier="resident"))
    with pytest.raises(NotImplementedError, match="precision"):
        execute(p, Plan(tier="host_loop", precision="mixed"))


def test_fusion_schedule_matches_reference():
    from repro.exec.adapters import fusion_schedule as jax_fusion_schedule
    for steps, t in itertools.product(range(0, 12), range(1, 6)):
        assert fusion_schedule(steps, t) == jax_fusion_schedule(steps, t)


def test_operand_fingerprint_matches_reference():
    a = np.random.default_rng(8).standard_normal((17, 9)).astype(np.float32)
    assert operand_fingerprint(torch.from_numpy(a)) == jax_fingerprint(jnp.asarray(a))
    assert operand_fingerprint(a, None) == jax_fingerprint(a, None)
    assert operand_fingerprint(torch.from_numpy(a)) != operand_fingerprint(
        torch.from_numpy(a + 1))


def test_domain_from_numpy_on_cpu():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = domain_from_numpy(a, "cpu")
    assert t.is_contiguous() and np.array_equal(t.numpy(), a)


# -- cache policy and performance model --------------------------------------------

_GRID = list(itertools.product((1, 7, 64, 300), (4, 512, 4096), (1, 2, 6),
                               (1, 2, 4)))


def test_stencil_cache_regions_match_reference():
    for shard_rows, row_bytes, r, t in _GRID:
        got = tcp.stencil_shard_arrays(shard_rows, row_bytes, r, fuse_steps=t)
        want = jcp.stencil_shard_arrays(shard_rows, row_bytes, r, fuse_steps=t)
        assert [vars(a) for a in got] == [vars(a) for a in want]
        assert [a.traffic_saved_per_byte() for a in got] == \
            [a.traffic_saved_per_byte() for a in want]
        got = tcp.stencil_arrays(shard_rows, row_bytes, r)
        want = jcp.stencil_arrays(shard_rows, row_bytes, r)
        assert [vars(a) for a in got] == [vars(a) for a in want]


def test_gm_bytes_fused_matches_reference():
    for (n, row_bytes, r, t), frac in itertools.product(
            _GRID, (0.0, 0.3, 1.0)):
        dom = 97 * row_bytes
        cached = int(frac * dom)
        kw = dict(row_bytes=row_bytes, radius=r, fuse_steps=t)
        assert tcp.gm_bytes_fused(n, dom, cached, **kw) == \
            jcp.gm_bytes_fused(n, dom, cached, **kw)


def test_perf_model_matches_reference():
    fields = dict(peak_flops=1e14, hbm_bw=2e12, hbm_bytes=8e10,
                  onchip_bytes=3e7, onchip_bw=3e13)
    tchip = thw.Chip(name="x", **fields)
    jchip = jhw.Chip(name="x", **fields)
    for n, cells in itertools.product((0, 1, 10, 1000), (64, 10**6)):
        assert vars(tpm.project_host_loop(
            tchip, n_steps=n, domain_cells=cells, dtype_bytes=4)) == vars(
            jpm.project_host_loop(jchip, n_steps=n, domain_cells=cells,
                                  dtype_bytes=4))
        assert tpm.sm_bytes_accessed(n, cells) == jpm.sm_bytes_accessed(n, cells)


# -- the H100 planner ----------------------------------------------------------------

def _meta_problem(shape, n, name="2d5pt"):
    """A problem with shapes only: planning launches nothing."""
    return StencilProblem(torch.empty(shape, device="meta"), get_spec(name),
                          n, device="meta")


def _fits_one_cta(c, shape, radius, dtype_bytes, chip):
    """Whether the kernel of resident candidate ``c`` holds its layout in
    one CTA's shared memory on ``chip``."""
    from repro_torch.kernels import stencil2d
    limit = chip.smem_per_block - stencil2d.PERKS_STATIC_SMEM
    if c.fuse_steps == 1 and c.schedule == "shallow":
        # every row cached: stencil_resident where it holds the domain,
        # else the one-step kernel's boxes
        if c.cached_rows == shape[0] and stencil2d.resident_layout(
                shape, radius, dtype_bytes, chip.sms, limit) is not None:
            return True
        lay = stencil2d.perks_layout(shape, radius, dtype_bytes, chip.sms,
                                     limit, c.cached_rows)
        return lay is not None and lay.smem <= limit
    lay = stencil2d.tb_layout(shape, radius, c.fuse_steps, dtype_bytes,
                              deep=c.schedule == "deep", ctas=chip.sms,
                              limit=limit, cached_rows=c.cached_rows)
    return lay is not None and lay.smem <= limit


@pytest.mark.parametrize("shape,n", [((8192, 8192), 100), ((3072, 1152), 1000),
                                     ((160, 160, 128), 50), ((48, 64), 7)])
def test_planner_offers_the_three_tiers_and_nothing_unported(shape, n):
    name = "2d5pt" if len(shape) == 2 else "3d7pt"
    cands = plan_candidates(_meta_problem(shape, n, name), chip="h100")
    assert {c.tier for c in cands} == {"device_loop", "host_loop",
                                       "resident"}
    assert sorted(c.tier for c in cands if c.tier != "resident") == [
        "device_loop", "host_loop"]
    res = [c for c in cands if c.tier == "resident"]
    shallow = sorted(c.fuse_steps for c in res if c.schedule == "shallow")
    deep = sorted(c.fuse_steps for c in res if c.schedule == "deep")
    assert shallow == [t for t in (1, 2, 4) if t <= n]
    assert deep and deep == [2 ** k for k in range(1, len(deep) + 1)]
    assert deep[-1] <= min(32, n)
    for c in res:
        assert _fits_one_cta(c, shape, get_spec(name).radius, 4, thw.H100), c
        assert c.sub_rows >= get_spec(name).radius * (
            c.fuse_steps if c.schedule == "shallow" else 1)
    assert all(c.chip == "h100" for c in cands)
    assert cands == sorted(cands, key=lambda c: c.predicted_s)


def test_planner_caches_whole_small_domain_and_part_of_large():
    small = plan(_meta_problem((3072, 1152), 1000))
    assert small.tier == "resident" and small.cached_rows == 3072
    assert small.cache[0].cached_bytes == small.cache[0].total_bytes
    large_cands = plan_candidates(_meta_problem((8192, 8192), 100))
    one = next(c for c in large_cands
               if c.tier == "resident" and c.fuse_steps == 1)
    assert 0 < one.cached_rows < 8192
    # one band of 5 rows (32 KiB each) per SM on the H100's 132 SMs, beside
    # the streamed rows' window
    assert one.cached_rows == 132 * 5
    # 80 KiB planes: the one-step kernel's boxes of half a plane each (66
    # bands of 2-3 planes by 2 slabs of 80 plane rows) hold every plane
    assert next(c for c in plan_candidates(_meta_problem((160, 160, 128), 50,
                                                         "3d7pt"))
                if c.tier == "resident"
                and c.fuse_steps == 1).cached_rows == 160
    # temporal blocking keeps 2*r*t halo rows beside a band: at 8192
    # columns no band fits beside them; the shallow tiles at t = 4 stream
    # the domain a quarter as often as the one-step kernel and measured
    # 13.1 ms against its 30.3 on an H100 (PERF.md), so they are the pick
    for c in large_cands:
        if c.tier == "resident" and c.fuse_steps > 1:
            assert c.cached_rows == 0, c
    large = plan(_meta_problem((8192, 8192), 100))
    assert (large.tier, large.fuse_steps, large.schedule,
            large.cached_rows) == ("resident", 4, "shallow", 0)
    assert (small.fuse_steps, small.schedule) == (1, "shallow")


def test_planner_charges_the_device_loop_its_capture_until_kept(monkeypatch):
    from repro_torch.exec import planner
    prob = _meta_problem((3072, 1152), 1000)
    assert prob.step_fn() is prob.step_fn()   # one step function per problem
    by_tier = {c.tier: c for c in plan_candidates(prob)}
    o = planner.DISPATCH_OVERHEAD_S
    assert by_tier["device_loop"].predicted_s == pytest.approx(
        by_tier["host_loop"].predicted_s + o)
    monkeypatch.setattr(perks, "graph_cached", lambda *a: True)
    by_tier = {c.tier: c for c in plan_candidates(prob)}
    assert by_tier["device_loop"].predicted_s == pytest.approx(
        by_tier["host_loop"].predicted_s - (1000 - 1) * o)


def test_plan_resident_planes_counts_only_what_a_cta_holds():
    from repro_torch.kernels.stencil3d import plan_resident_planes
    h100 = thw.H100
    # 1 MiB planes: boxes of 12 plane rows by 5 planes, 3 bands of 43 slabs
    assert plan_resident_planes((512, 512, 512), 4, get_spec("3d7pt"),
                                chip=h100) == 15
    # 80 KiB planes, r = 2: boxes of half a plane hold every plane
    assert plan_resident_planes((160, 160, 128), 4, get_spec("3d13pt"),
                                chip=h100) == 160
    assert plan_resident_planes((40, 64), 4, get_spec("2d5pt"),
                                chip=h100) == 40
