"""The batched resident tier of a stencil batch (``exec/batch.py``,
``StencilProblem.run_resident_batched``): B domains in one cooperative
launch of ``stencil_perks``, ``stencil_resident``, the shallow tiles or the
deep pipelines, lane b on ``sms // B`` CTAs (``stencil2d.lane_ctas``).

On the CPU the wrappers run their plain versions, so what is held here is
everything around the kernels: a batched resident ``execute`` is bit-equal
to the port's ``execute_sequential`` and within the reference's bound of
the reference's per-instance runs (atol 5e-6, rtol 0; bf16 2e-2; the
reference's own batched stencil runs are not the ground truth, its
per-instance runs are), on all 13 Table-III specs at t = 1 and on 2d5pt
and 3d7pt at shallow and deep t = 2; the planner's batched resident
candidates and a lane's cached rows against B; the co-resident limit;
``lane_ctas``, ``per_instance_chip`` and a plan fitted to a lane. The
kernels themselves are held lane by lane in ``test_torch_cuda.py``.

Inputs are made with numpy from a seed and handed to both packages.
"""
import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.exec import Plan as JaxPlan
from repro.exec import StencilProblem as JaxStencilProblem
from repro.exec import execute_sequential as jax_execute_sequential
from repro.kernels.common import get_spec as jax_get_spec
from repro_torch.core.hardware import H100
from repro_torch.exec import (BatchedProblem, Plan, StencilProblem, execute,
                              execute_sequential, per_instance_chip,
                              plan_candidates)
from repro_torch.exec.adapters import fit_stencil_plan
from repro_torch.kernels import ops, ref, stencil2d
from repro_torch.kernels.common import BENCHMARKS, get_spec

B = 3
STEPS = 3
ATOL = 5e-6
BF16_ATOL = 2e-2
NAMES = sorted(BENCHMARKS)


def _domains(spec, b=B, seed=0):
    shape = (48, 64) if spec.ndim == 2 else (24, 16, 32)
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(b)]


def _batch(name, b=B, steps=STEPS, dtype=torch.float32, seed=0):
    spec = get_spec(name)
    xs = _domains(spec, b, seed)
    insts = [StencilProblem(torch.from_numpy(x).to(dtype), spec, steps,
                            device="cpu") for x in xs]
    return xs, insts, BatchedProblem.from_instances(insts)


def _reference(name, xs, plan, dtype=jnp.float32, steps=STEPS):
    jinsts = [JaxStencilProblem(jnp.asarray(x, dtype), jax_get_spec(name),
                                steps) for x in xs]
    return jax_execute_sequential(jinsts, plan)


def _check(name, xs, insts, bp, single, jplan, atol=ATOL,
           jdtype=jnp.float32):
    out = execute(bp, dataclasses.replace(single, batch=bp.batch))
    assert out.shape == (bp.batch,) + tuple(insts[0].x.shape)
    seq = execute_sequential(insts, single)
    for got, want in zip(bp.split(out), seq):
        assert torch.equal(got, want)
    for got, want in zip(bp.split(out), _reference(name, xs, jplan, jdtype)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("name", NAMES)
def test_batched_resident_one_step_matches_sequential(name):
    xs, insts, bp = _batch(name)
    assert bp.supports("resident")
    rows = insts[0].x.shape[0] // 2
    _check(name, xs, insts, bp,
           Plan(tier="resident", cached_rows=rows, sub_rows=8),
           JaxPlan(tier="resident", cached_rows=rows, sub_rows=8))


@pytest.mark.parametrize("schedule", ["shallow", "deep"])
@pytest.mark.parametrize("name", ["2d5pt", "3d7pt"])
def test_batched_resident_temporal_blocking_matches_sequential(name,
                                                               schedule):
    xs, insts, bp = _batch(name)
    rows = insts[0].x.shape[0] // 2
    kw = dict(tier="resident", cached_rows=rows, sub_rows=8, fuse_steps=2,
              schedule=schedule)
    _check(name, xs, insts, bp, Plan(**kw), JaxPlan(**kw))


@pytest.mark.parametrize("name", ["2d5pt", "3d7pt"])
def test_batched_resident_whole_domain_and_bf16(name):
    xs, insts, bp = _batch(name, dtype=torch.bfloat16)
    H = insts[0].x.shape[0]
    for rows, t in ((H, 1), (H // 2, 1), (H // 2, 2)):
        kw = dict(tier="resident", cached_rows=rows, sub_rows=8, fuse_steps=t)
        _check(name, xs, insts, bp, Plan(**kw), JaxPlan(**kw),
               atol=BF16_ATOL, jdtype=jnp.bfloat16)


def test_batched_resident_candidates_and_lane_rows_do_not_grow_with_b():
    spec = get_spec("2d5pt")
    problem = StencilProblem(torch.zeros(2048, 2048), spec, 100,
                             device="cpu")
    prev = {}
    for b in (1, 2, 4, 8, 33, 132):
        res = [c for c in plan_candidates(problem, batch=b)
               if c.tier == "resident"]
        assert res and all(c.batch == b for c in res)
        lane = per_instance_chip(H100, b)
        for c in res:
            key = (c.schedule, c.fuse_steps)
            assert c.cached_rows <= prev.get(key, 2048), (b, c)
            prev[key] = c.cached_rows
            # each is fitted as it is offered: one domain on a lane's CTAs
            assert fit_stencil_plan((2048, 2048), 4, spec, c, lane)[1] is None
    # the whole card holds the domain; 16 CTAs a lane (B = 8) a part
    one = {(c.schedule, c.fuse_steps): c.cached_rows
           for c in plan_candidates(problem) if c.tier == "resident"}
    eight = {(c.schedule, c.fuse_steps): c.cached_rows
             for c in plan_candidates(problem, batch=8)
             if c.tier == "resident"}
    assert one[("shallow", 1)] == 2048 > eight[("shallow", 1)] > 0
    # a BatchedProblem gives its own B, and its resident plans run it
    _, insts, bp = _batch("2d5pt")
    cands = plan_candidates(bp)
    assert {c.tier for c in cands} == {"host_loop", "device_loop",
                                       "resident"}
    seq = execute_sequential(insts, dataclasses.replace(cands[0], batch=1,
                                                        problem=""))
    for got, want in zip(bp.split(execute(bp, cands[0])), seq):
        assert torch.equal(got, want)


def test_no_resident_candidate_above_the_co_resident_limit():
    spec = get_spec("2d5pt")
    one = StencilProblem(np.zeros((16, 16), np.float32), spec, 2,
                         device="cpu")
    assert "resident" in {c.tier for c in plan_candidates(one,
                                                          batch=H100.sms)}
    assert "resident" not in {c.tier for c in plan_candidates(
        one, batch=H100.sms + 1)}
    rng = np.random.default_rng(3)
    insts = [one.with_payload(torch.from_numpy(
        rng.standard_normal((16, 16)).astype(np.float32)))
        for _ in range(H100.sms + 1)]
    bp = BatchedProblem.from_instances(insts)
    assert bp.supports("resident")
    assert "resident" not in {c.tier for c in plan_candidates(bp)}
    with pytest.raises(ValueError, match="outnumber"):
        execute(bp, Plan(tier="resident", batch=bp.batch, cached_rows=16))
    # the loop tiers still take it
    out = execute(bp, Plan(tier="device_loop", batch=bp.batch))
    assert torch.equal(out[-1], ref.stencil_run(insts[-1].x, spec, 2))


def test_lane_ctas_and_per_instance_chip():
    assert stencil2d.lane_ctas(132, 1) == 132
    assert stencil2d.lane_ctas(132, 8) == 16
    assert stencil2d.lane_ctas(132, 33) == 4
    assert stencil2d.lane_ctas(132, 132) == 1
    assert stencil2d.lane_ctas(132, 133) == 0
    assert stencil2d.lane_ctas(264, 2) == 132
    assert per_instance_chip(H100, 1) is H100
    for b, sms in ((2, 66), (8, 16), (33, 4), (132, 1), (133, 0)):
        lane = per_instance_chip(H100, b)
        assert lane.sms == sms
        assert lane.smem_per_block == H100.smem_per_block
        assert lane.onchip_bytes == sms * H100.smem_per_block
    # a budget below the lanes' share stays the budget
    small = dataclasses.replace(H100, onchip_bytes=1e6)
    assert per_instance_chip(small, 8).onchip_bytes == 1e6 / 8


def test_a_plan_the_card_holds_but_a_lane_does_not_is_fitted_once():
    """The single run's plan caching most of what the card holds: a lane of
    four (33 CTAs) holds fewer rows, so the batched run fits it to the
    lane's layout with one RuntimeWarning and gives every lane its single
    run's bits."""
    spec = get_spec("2d5pt")
    shape = (600, 8192)
    single = next(c for c in plan_candidates(
        StencilProblem(torch.zeros(shape), spec, 2, device="cpu"))
        if c.tier == "resident" and c.fuse_steps == 1)
    assert single.cached_rows > 300
    plan = Plan(tier="resident", cached_rows=single.cached_rows,
                sub_rows=128)
    assert fit_stencil_plan(shape, 4, spec, plan, H100)[1] is None
    fitted, why = fit_stencil_plan(shape, 4, spec, plan,
                                   per_instance_chip(H100, 4))
    assert why is not None and "33 CTAs" in why
    assert 0 < fitted.cached_rows < single.cached_rows
    assert stencil2d.perks_layout(shape, 1, 4, 33, H100.smem_per_block
                                  - stencil2d.PERKS_STATIC_SMEM,
                                  fitted.cached_rows) is not None
    rng = np.random.default_rng(7)
    insts = [StencilProblem(rng.standard_normal(shape).astype(np.float32),
                            spec, 2, device="cpu") for _ in range(4)]
    bp = BatchedProblem.from_instances(insts)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = execute(bp, dataclasses.replace(plan, batch=4))
    assert [w.category for w in seen] == [RuntimeWarning]
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # the single run fits the card
        seq = execute_sequential(insts, plan)
    for got, want in zip(bp.split(out), seq):
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["2d25pt", "3d13pt"])
def test_wrappers_take_a_batch_of_domains_on_the_cpu(name):
    spec = get_spec(name)
    xs = torch.from_numpy(np.stack(_domains(spec, 4, seed=5)))
    want = torch.stack([ref.stencil_run(x, spec, 4) for x in xs])
    assert torch.equal(ref.stencil_run(xs, spec, 4), want)
    H = xs.shape[1]
    for got in (
            ops.stencil_resident(xs, spec=spec, steps=4),
            ops.stencil_perks(xs, spec=spec, steps=4, cached_rows=H // 2),
            ops.stencil_perks(xs, spec=spec, steps=4, cached_rows=H // 2,
                              fuse_steps=2),
            ops.stencil_perks_deep(xs, spec=spec, steps=4, cached_rows=H // 2,
                                   fuse_steps=2)):
        assert torch.equal(got, want)
    # the preconditions read one domain's rows, not the lanes
    with pytest.raises(ValueError, match="cached_rows"):
        ops.stencil_perks(xs, spec=spec, steps=4, cached_rows=H + 1)
    with pytest.raises(ValueError, match="partial caching"):
        ops.stencil_perks(xs, spec=spec, steps=4, cached_rows=1)


def test_the_kernels_checks_take_a_batch_of_domains():
    spec = get_spec("2d5pt")
    stencil2d._check_cuda(torch.zeros(3, 16, 16), spec, batched=True)
    stencil2d._check_cuda(torch.zeros(16, 16), spec, batched=True)
    with pytest.raises(ValueError, match="2D domain"):
        stencil2d._check_cuda(torch.zeros(3, 16, 16), spec)
    with pytest.raises(ValueError, match="or a batch"):
        stencil2d._check_cuda(torch.zeros(2, 3, 16, 16), spec, batched=True)
    with pytest.raises(ValueError, match="contiguous"):
        stencil2d._check_cuda(torch.zeros(16, 3, 16).transpose(0, 1), spec,
                              batched=True)
    # 8 lanes of 2^28 cells: each lane within 32-bit indexing, the batch
    # not (the kernels offset a lane in 64 bits); one domain of 2^31 not
    stencil2d._check_cuda(torch.empty(8, 16384, 16384, device="meta"), spec,
                          batched=True)
    with pytest.raises(ValueError, match="32-bit"):
        stencil2d._check_cuda(torch.empty(2, 65536, 32768, device="meta"),
                              spec, batched=True)
    assert stencil2d._lanes(torch.empty(0, 4, 4), spec) == ((4, 4), 0)
    assert stencil2d._lanes(torch.empty(4, 4), spec) == ((4, 4), 1)
