"""The port's CUDA kernels and tiers on the card, against its own plain torch
version (the JAX parity of that plain version is in ``test_torch_stencil``
and ``test_torch_exec``).

This file imports nothing of JAX or of the reference package, so it also
runs on a machine without them:

    PYTHONPATH=src python3 -m pytest -q --noconftest tests/test_torch_cuda.py

Every test needs a CUDA device and skips, with its reason, where torch
finds none.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import perks
from repro_torch.exec import CGProblem, Plan, StencilProblem, execute, plan
from repro_torch.exec import plan_candidates
from repro_torch.kernels import ops, ref, stencil2d
from repro_torch.kernels.common import BENCHMARKS, get_spec
from repro_torch.solvers.cg import SellOperator
from repro_torch.sparse import generate, nonsymmetric_names, symmetric_names
from repro_torch.sparse.generate import convdiff2d, poisson2d, poisson3d

NAMES = sorted(BENCHMARKS)
STEPS = 5
SPD = symmetric_names()
# The SpMVs against their plain version: the reference's SpMV bound plus a
# relative term, as the order of summation may differ.
SPMV_TOL = dict(rtol=1e-5, atol=1e-5)
# CG on the card against the plain version: the reference's fused-CG bound
# (tests/test_kernels_linalg.py); the dot products sum in another order.
CG_TOL = dict(rtol=1e-3, atol=1e-5)

pytestmark = pytest.mark.cuda


def _domain(spec, seed=0):
    shape = (32, 40) if spec.ndim == 2 else (20, 14, 18)
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", NAMES)
def test_cuda_kernels_match_plain_version(name, cuda):
    spec = get_spec(name)
    x = torch.from_numpy(_domain(spec, seed=4)).to(cuda)
    want = ref.stencil_run(x, spec, STEPS)
    for rows in (0, max(spec.radius, x.shape[0] // 2), x.shape[0]):
        before = ops.launch_counts()["stencil_resident"]
        got = ops.stencil_perks(x, spec=spec, steps=STEPS, cached_rows=rows)
        assert torch.equal(got, want), (name, rows)
        # every row cached runs the whole domain's kernel
        assert ops.launch_counts()["stencil_resident"] - before == (
            rows == x.shape[0])
    assert torch.equal(ops.stencil_resident(x, spec=spec, steps=STEPS), want)
    assert torch.equal(ops.stencil_baseline_step(x, spec=spec),
                       ref.stencil_step(x, spec))


def test_cuda_wrappers_refuse_what_the_kernel_does_not_do(cuda):
    spec = get_spec("2d5pt")
    x = torch.from_numpy(_domain(spec)).to(cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.stencil_perks(x.half(), spec=spec, steps=4, cached_rows=8,
                          fuse_steps=2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.stencil_baseline_step(x.double(), spec=spec)
    big = torch.zeros((40000, 8192), device=cuda)
    with pytest.raises(ValueError, match="holds at most"):
        ops.stencil_resident(big, spec=spec, steps=1)
    # r*t = 192-cell halos: a one-cell strip's level rings alone need more
    # than a CTA's shared memory
    wide = get_spec("2ds25pt")
    y = torch.zeros((64, 512), device=cuda)
    with pytest.raises(ValueError, match="a CTA has"):
        ops.stencil_perks_deep(y, spec=wide, steps=32, cached_rows=0,
                               fuse_steps=32)


@pytest.mark.parametrize("name", NAMES)
def test_cuda_temporal_blocking_matches_plain_version(name, cuda):
    """csrc/stencil_tb.cu, both schedules, with and without cached bands,
    11 steps (a remainder pass), against the plain version: bit for bit."""
    spec = get_spec(name)
    x = torch.from_numpy(_domain(spec, seed=12)).to(cuda)
    want = ref.stencil_run(x, spec, 11)
    before = ops.launch_counts()
    for rows in (0, 4 * spec.radius + 1):
        for t in (2, 3, 4):
            got = ops.stencil_perks(x, spec=spec, steps=11, cached_rows=rows,
                                    sub_rows=32, fuse_steps=t)
            assert torch.equal(got, want), (name, rows, t)
        for t in (2, 3, 8):
            got = ops.stencil_perks_deep(x, spec=spec, steps=11,
                                         cached_rows=rows, fuse_steps=t)
            assert torch.equal(got, want), (name, rows, t, "deep")
    after = ops.launch_counts()
    assert after["stencil_perks_fused"] == before["stencil_perks_fused"] + 6
    assert after["stencil_perks_deep"] == before["stencil_perks_deep"] + 6
    assert after["stencil_perks"] == before["stencil_perks"]


@pytest.mark.parametrize("name", NAMES)
def test_cuda_bf16_kernels_match_plain_version(name, cuda):
    """bf16 cells: every product and partial sum rounded to bf16, as the
    plain torch version rounds them; gated at the reference's bf16 bound."""
    spec = get_spec(name)
    x = torch.from_numpy(_domain(spec, seed=13)).to(cuda).to(torch.bfloat16)
    r = spec.radius
    want = ref.stencil_run(x, spec, STEPS)
    got = [ops.stencil_baseline_step(x, spec=spec),
           ops.stencil_resident(x, spec=spec, steps=STEPS),
           ops.stencil_perks(x, spec=spec, steps=STEPS, cached_rows=4 * r + 1),
           ops.stencil_perks(x, spec=spec, steps=STEPS, cached_rows=0,
                             sub_rows=32, fuse_steps=2),
           ops.stencil_perks_deep(x, spec=spec, steps=STEPS,
                                  cached_rows=4 * r + 1, fuse_steps=4)]
    wants = [ref.stencil_step(x, spec)] + [want] * 4
    for g, w in zip(got, wants):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=2e-2)


@pytest.mark.parametrize("name", NAMES)
def test_cuda_tiers_agree_bit_for_bit(name, cuda):
    spec = get_spec(name)
    x = _domain(spec, seed=9)
    p = StencilProblem(x, spec, STEPS, device=cuda)
    want = p.oracle()
    for pl in (Plan(tier="host_loop"), Plan(tier="device_loop"),
               Plan(tier="resident", cached_rows=x.shape[0]),
               Plan(tier="resident", cached_rows=max(spec.radius,
                                                     x.shape[0] // 2)),
               plan(p)):
        assert torch.equal(execute(p, pl), want), pl.tier


@pytest.mark.parametrize("name", ["2d5pt", "2ds25pt", "3d7pt", "poisson"])
def test_cuda_tiers_agree_on_fused_and_deep_plans(name, cuda):
    spec = get_spec(name)
    x = _domain(spec, seed=14)
    p = StencilProblem(x, spec, 9, device=cuda)
    want = p.oracle()
    rows = 4 * spec.radius + 1
    plans = [c for c in plan_candidates(p) if c.tier == "resident"]
    plans += [Plan(tier="resident", fuse_steps=t, schedule=sched,
                   cached_rows=R, sub_rows=32)
              for sched, t, R in (("shallow", 2, 0), ("shallow", 4, rows),
                                  ("deep", 8, 0), ("deep", 3, rows))]
    assert {c.schedule for c in plans if c.fuse_steps > 1} == {"shallow",
                                                               "deep"}
    for pl in plans:
        assert torch.equal(execute(p, pl), want), pl


# The deep schedule's level pipeline on domains its TMA loads do not take
# (columns not a multiple of 4 or 16 cells, a view off a 16-byte boundary)
# and on ones they do, f32 and bf16, 2D and 3D, with and without cached
# bands, 13 steps (13 % t != 0): bit for bit against the plain version.
DEEP_CASES = [  # (spec, shape, loads level 0 by TMA)
    ("2d5pt", (45, 37), False), ("2d9pt", (50, 13), False),
    ("2ds25pt", (61, 90), False), ("2d5pt", (64, 96), True),
    ("2ds9pt", (40, 256), True), ("3d7pt", (19, 13, 11), False),
    ("3d27pt", (21, 10, 7), False), ("3d7pt", (24, 16, 32), True),
    ("3d13pt", (22, 24, 16), True), ("poisson", (17, 12, 40), True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,shape,aligned", DEEP_CASES)
def test_cuda_deep_pipeline_is_bit_equal(name, shape, aligned, dtype, cuda):
    spec = get_spec(name)
    x = torch.from_numpy(np.random.default_rng(len(shape)).standard_normal(
        shape).astype(np.float32)).to(cuda).to(dtype)
    want = ref.stencil_run(x, spec, 13)
    tma = aligned and (shape[-1] * x.element_size()) % 16 == 0
    for rows in (0, 4 * spec.radius + 1):
        for t in (2, 5, 8):
            before = ops.launch_counts()
            got = ops.stencil_perks_deep(x, spec=spec, steps=13,
                                         cached_rows=rows, fuse_steps=t)
            after = ops.launch_counts()
            assert torch.equal(got, want), (rows, t)
            assert after["stencil_perks_deep"] == \
                before["stencil_perks_deep"] + 1
            assert after["stencil_perks_deep_tma"] == \
                before["stencil_perks_deep_tma"] + tma, (rows, t)
    # the same domain as a view 4 bytes off a 16-byte boundary: no TMA
    buf = torch.empty(x.numel() + 2, dtype=dtype, device=cuda)
    view = buf[2:].view(shape)
    view.copy_(x)
    assert view.data_ptr() % 16
    before = ops.launch_counts()["stencil_perks_deep_tma"]
    got = ops.stencil_perks_deep(view, spec=spec, steps=13, cached_rows=0,
                                 fuse_steps=5)
    assert torch.equal(got, want)
    assert ops.launch_counts()["stencil_perks_deep_tma"] == before


def test_cuda_deep_pipeline_at_the_depth_limit(cuda):
    """t = 32 (a warp holds more than one level, the level rings fill a
    CTA) and t = 31, with a last pass of one step, on several segments."""
    spec = get_spec("2d5pt")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (300, 640)).astype(np.float32)).to(cuda)
    for t, steps in ((32, 65), (31, 63), (32, 33)):
        props = torch.cuda.get_device_properties(cuda)
        lay = stencil2d.tb_layout(
            tuple(x.shape), 1, t, 4, deep=True,
            ctas=props.multi_processor_count, cached_rows=0,
            limit=(props.shared_memory_per_block_optin
                   - stencil2d.PERKS_STATIC_SMEM))
        assert lay is not None and lay.rows < x.shape[0]
        got = ops.stencil_perks_deep(x, spec=spec, steps=steps,
                                     cached_rows=0, fuse_steps=t)
        assert torch.equal(got, ref.stencil_run(x, spec, steps)), t


@pytest.mark.parametrize("name,shape,dtype,t,rows,rings", [
    ("2d17pt", (256, 384), torch.float32, 32, 0, 0),
    ("2d13pt", (256, 384), torch.bfloat16, 32, 13, 0),
    ("3d13pt", (48, 40, 56), torch.bfloat16, 8, 9, 1),
    ("3d17pt", (48, 40, 56), torch.bfloat16, 8, 9, 1),
])
def test_cuda_deep_pipeline_on_fallback_layouts(name, shape, dtype, t, rows,
                                                rings, cuda):
    """Layouts that take a narrower strip of a window class or shallower
    rings (2r + 2 a level) run bit for bit, with a last short pass."""
    spec = get_spec(name)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32)).to(cuda).to(dtype)
    props = torch.cuda.get_device_properties(cuda)
    lay = stencil2d.tb_layout(
        shape, spec.radius, t, x.element_size(), deep=True,
        ctas=props.multi_processor_count, cached_rows=rows,
        limit=props.shared_memory_per_block_optin - stencil2d.PERKS_STATIC_SMEM)
    assert lay is not None and lay.rings == stencil2d.deep_rings(
        spec.radius)[rings]
    steps = t + 5
    got = ops.stencil_perks_deep(x, spec=spec, steps=steps, cached_rows=rows,
                                 sub_rows=max(128, spec.radius * t),
                                 fuse_steps=t)
    assert torch.equal(got, ref.stencil_run(x, spec, steps))


# The redesigned stencil_resident (csrc/stencil_resident.cu) and shallow
# tiles (csrc/stencil_shallow.cu) at edge shapes, f32 and bf16, bit for bit
# against the plain version: fewer rows than 132 bands, widths that are no
# multiple of a tile or of 16 bytes, odd steps, and steps % t != 0.
EDGE_2D = [(100, 37), (45, 250), (300, 1153)]
EDGE_3D = [(30, 9, 11), (40, 20, 36), (17, 12, 40)]


def _edge_domain(shape, dtype, cuda, seed=21):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(cuda).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_resident_kernel_is_bit_equal_at_edge_shapes(name, dtype, cuda):
    spec = get_spec(name)
    for shape in (EDGE_2D if spec.ndim == 2 else EDGE_3D):
        x = _edge_domain(shape, dtype, cuda)
        before = ops.launch_counts()["stencil_resident"]
        got = ops.stencil_resident(x, spec=spec, steps=7)
        assert ops.launch_counts()["stencil_resident"] == before + 1
        assert torch.equal(got, ref.stencil_run(x, spec, 7)), shape


def _res_limit(cuda):
    props = torch.cuda.get_device_properties(cuda)
    return (props.multi_processor_count,
            props.shared_memory_per_block_optin - stencil2d.PERKS_STATIC_SMEM)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["2d5pt", "2d9pt", "2ds25pt", "3d7pt",
                                  "3d27pt", "poisson"])
def test_cuda_resident_kernel_across_blocks_and_at_capacity(name, dtype,
                                                            cuda):
    """Bands wider than the registers hold (several blocks a step, each
    written r rows from its old place), and a domain at the one-step
    kernel's capacity, where no halo rows fit and a band's first and last
    r rows read the rows outside it from device memory: bit for bit, odd
    steps."""
    spec = get_spec(name)
    r = spec.radius
    sms, limit = _res_limit(cuda)
    eb = torch.empty((), dtype=dtype).element_size()
    rows = 2 * r + 2
    cells = stencil2d.RES_THREADS * stencil2d.RES_CELLS // rows + 1
    full = limit // (cells * eb) - r   # rows a CTA holds at most
    for m, halo in ((rows, True), (full, False)):
        if spec.ndim == 2:
            shape = (sms * m, cells)
        else:
            shape = (sms * m, 8, -(-cells // 8))
        lay = stencil2d.resident_layout(shape, r, eb, sms, limit)
        assert lay is not None and lay.blocks > 1, (shape, lay)
        assert lay.halo == halo, (shape, lay)
        x = _edge_domain(shape, dtype, cuda, seed=m)
        got = ops.stencil_resident(x, spec=spec, steps=5)
        assert torch.equal(got, ref.stencil_run(x, spec, 5)), shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_shallow_tiles_are_bit_equal_at_edge_shapes(name, dtype, cuda):
    """t = 2, 3, 4 with 13 steps (a short last pass), with and without
    cached bands; each launch counted as fused, and as copied by cp.async
    exactly where the rows are 16-byte aligned."""
    spec = get_spec(name)
    r = spec.radius
    for shape in (EDGE_2D if spec.ndim == 2 else EDGE_3D):
        x = _edge_domain(shape, dtype, cuda, seed=5)
        want = ref.stencil_run(x, spec, 13)
        aligned = (shape[-1] * x.element_size()) % 16 == 0
        for rows in (0, 4 * r + 1):
            for t in (2, 3, 4):
                sms, limit = _res_limit(cuda)
                if stencil2d.tb_layout(shape, r, t, x.element_size(),
                                       deep=False, ctas=sms, limit=limit,
                                       cached_rows=rows) is None:
                    continue
                before = ops.launch_counts()
                got = ops.stencil_perks(x, spec=spec, steps=13,
                                        cached_rows=rows,
                                        sub_rows=max(128, r * t),
                                        fuse_steps=t)
                after = ops.launch_counts()
                assert torch.equal(got, want), (shape, rows, t)
                assert after["stencil_perks_fused"] == \
                    before["stencil_perks_fused"] + 1
                assert after["stencil_perks_fused_async"] == \
                    before["stencil_perks_fused_async"] + aligned


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_one_step_kernel_is_bit_equal_at_edge_shapes(name, dtype, cuda):
    """csrc/stencil_perks.cu with rows streamed (0 < R < H), 9 steps (odd,
    so the boxes end shifted), at shapes whose rows are and are not 16-byte
    aligned: bit for bit, each launch counted, and fed its window by bulk
    copies exactly where the rows are aligned."""
    spec = get_spec(name)
    r = spec.radius
    sms, limit = _res_limit(cuda)
    for shape in (EDGE_2D if spec.ndim == 2 else EDGE_3D):
        x = _edge_domain(shape, dtype, cuda, seed=9)
        want = ref.stencil_run(x, spec, 9)
        aligned = (shape[-1] * x.element_size()) % 16 == 0
        cap = stencil2d.perks_cached_rows(shape, r, x.element_size(), sms,
                                          limit)
        for rows in sorted({0, r, 4 * r + 1, cap}):
            if rows >= shape[0]:
                continue
            before = ops.launch_counts()
            got = ops.stencil_perks(x, spec=spec, steps=9, cached_rows=rows)
            after = ops.launch_counts()
            assert torch.equal(got, want), (shape, rows)
            assert after["stencil_perks"] == before["stencil_perks"] + 1
            assert after["stencil_perks_window"] == \
                before["stencil_perks_window"] + aligned


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["3d7pt", "3d13pt", "3d27pt", "poisson"])
def test_cuda_one_step_boxes_on_wide_planes(name, dtype, cuda):
    """Planes of 160 x 160 cells, wider than a CTA's registers hold: the
    cached planes are cut into boxes of plane rows (perks_layout), with
    rows streamed and with every plane cached; bit for bit."""
    spec = get_spec(name)
    sms, limit = _res_limit(cuda)
    shape = (24, 160, 160)
    x = _edge_domain(shape, dtype, cuda, seed=3)
    want = ref.stencil_run(x, spec, 5)
    cap = stencil2d.perks_cached_rows(shape, spec.radius, x.element_size(),
                                      sms, limit)
    for rows in (cap, shape[0]):
        lay = stencil2d.perks_layout(shape, spec.radius, x.element_size(),
                                     sms, limit, rows)
        assert lay is not None and lay.nby > 1, (rows, lay)
        got = ops.stencil_perks(x, spec=spec, steps=5, cached_rows=rows)
        assert torch.equal(got, want), rows


def test_cuda_plans_the_card_cannot_hold_run_fitted(cuda):
    """A deep t = 8 plan caching more rows of 8192 columns than a band
    holds beside its halo, and a shallow t = 4 plan caching 3D planes
    wider than the bands hold: fitted with one RuntimeWarning, the plain
    version's bits."""
    for name, shape, plan_ in (
            ("2d5pt", (300, 8192), dict(schedule="deep", fuse_steps=8,
                                        cached_rows=200)),
            ("3d27pt", (24, 160, 160), dict(schedule="shallow", fuse_steps=4,
                                            cached_rows=20))):
        spec = get_spec(name)
        x = _edge_domain(shape, torch.float32, cuda, seed=4)
        p = Plan(tier="resident", n_steps=9, sub_rows=128, **plan_)
        with pytest.warns(RuntimeWarning, match="does not fit"):
            got = execute(StencilProblem(x, spec, 9, device=cuda), p)
        assert torch.equal(got, ref.stencil_run(x, spec, 9)), name


#: csrc/stencil_step.cu's ragged cases: P not a multiple of a 16-byte
#: chunk's cells, H < a tile's rows + 2r, 3D planes not multiples of the
#: tile, and rows not on 16-byte boundaries (odd widths)
STEP_SHAPES = {2: [(19, 130), (64, 1030), (17, 263), (13, 27)],
               3: [(9, 33, 66), (20, 17, 40), (13, 21, 35), (7, 9, 11)]}


def _step_once(x, spec):
    """One step and the counters it moved (each case: exactly one launch)."""
    before = ops.launch_counts()
    got = ops.stencil_baseline_step(x, spec=spec)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in ops.launch_counts().items()
             if v != before[k]}
    assert delta.get("stencil_baseline_step") == 1, delta
    return got, delta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_step_kernel_is_bit_equal_at_ragged_shapes(name, dtype, cuda):
    """The redesigned step on every Table-III spec (its compiled shapes)
    at ragged and unaligned shapes, bit for bit against ref.stencil_step;
    an unaligned row width takes the cell-by-cell copies, counted apart."""
    spec = get_spec(name)
    rng = np.random.default_rng(21)
    for shape in STEP_SHAPES[spec.ndim]:
        if min(shape) <= 2 * spec.radius:
            continue
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(cuda, dtype)
        got, delta = _step_once(x, spec)
        assert torch.equal(got, ref.stencil_step(x, spec)), (name, shape)
        aligned = shape[-1] * x.element_size() % 16 == 0
        assert delta.get("stencil_baseline_step_unaligned", 0) == (
            not aligned), (shape, delta)
        assert "stencil_baseline_step_runtime" not in delta, delta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_step_kernel_runtime_path_and_offset_tensor(dtype, cuda):
    """A spec that is none of the compiled shapes (radius 8, other weights)
    takes the runtime path; a tensor that starts off a 16-byte boundary is
    copied cell by cell; both bit for bit."""
    from repro_torch.kernels.common import StencilSpec, _box, _star
    rng = np.random.default_rng(22)
    for spec in (StencilSpec("star2d8", 2, tuple(_star(2, 8)[:25]),
                             tuple(0.5 / (k + 2) for k in range(25))),
                 StencilSpec("box3d2", 3, tuple(_box(3, 2)[:30]),
                             tuple(0.3 / (k + 1) for k in range(30)))):
        shape = (40, 70) if spec.ndim == 2 else (20, 17, 40)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(cuda, dtype)
        got, delta = _step_once(x, spec)
        assert delta.get("stencil_baseline_step_runtime") == 1, delta
        assert torch.equal(got, ref.stencil_step(x, spec)), spec.name
    spec = get_spec("2d5pt")
    flat = torch.from_numpy(rng.standard_normal(1 + 64 * 128).astype(
        np.float32)).to(cuda, dtype)
    x = flat[1:].view(64, 128)          # 2 or 4 bytes past a boundary
    got, delta = _step_once(x, spec)
    assert delta.get("stencil_baseline_step_unaligned") == 1, delta
    assert torch.equal(got, ref.stencil_step(x, spec))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_batched_step_lanes_at_ragged_shapes(name, dtype, cuda):
    """B = 3 domains of a ragged shape in one launch: each lane bit-equal to
    its own launch and to the plain version."""
    spec = get_spec(name)
    shape = STEP_SHAPES[spec.ndim][0] if spec.radius <= 4 else (
        (19, 130) if spec.ndim == 2 else (20, 17, 40))
    rng = np.random.default_rng(23)
    xs = torch.from_numpy(rng.standard_normal((3,) + shape).astype(
        np.float32)).to(cuda, dtype)
    got, delta = _step_once(xs, spec)
    assert delta.get("stencil_baseline_step_batched") == 1, delta
    for i in range(3):
        one, _ = _step_once(xs[i], spec)
        assert torch.equal(got[i], one), (name, i)
    assert torch.equal(got, ref.stencil_step(xs, spec))


def test_cuda_device_loop_keeps_its_graph(cuda):
    spec = get_spec("2d5pt")
    p = StencilProblem(_domain(spec, seed=10), spec, STEPS, device=cuda)
    want = p.oracle()
    perks.clear_graphs()
    first = execute(p, Plan(tier="device_loop"))
    assert perks.graph_cached(p.step_fn(), p.x, STEPS)
    before = ops.launch_counts()["stencil_baseline_step"]
    second = execute(p, Plan(tier="device_loop"))   # a replay: no new launch
    assert ops.launch_counts()["stencil_baseline_step"] == before
    assert torch.equal(first, want) and torch.equal(second, want)
    assert first.data_ptr() != second.data_ptr()
    perks.clear_graphs()
    assert not perks.graph_cached(p.step_fn(), p.x, STEPS)


# -- the batched resident stencil kernels ------------------------------------------
# B domains in one cooperative launch, lane b on the CTAs (x, b) of a grid
# (stencil2d.lane_ctas, B): each lane bit-equal to its own launch on the
# whole card and to the plain version. Aligned shapes take the deep
# kernel's TMA maps and the bulk and cp.async copies, ragged ones the
# loads through L2.

LANE_SHAPES = {2: [(96, 264), (77, 130)], 3: [(40, 36, 44), (23, 19, 30)]}
LANE_STEPS = 7


def _lane_kernels(spec):
    """(launch counter of the batched launch, the launch) of the four
    kernels: the one-step kernel and the shallow tiles at 4r + 1 cached
    rows, the deep pipelines likewise, the whole domain."""
    rows = 4 * spec.radius + 1
    n = LANE_STEPS
    return [
        ("stencil_perks_batched", lambda x: ops.stencil_perks(
            x, spec=spec, steps=n, cached_rows=rows)),
        ("stencil_shallow_batched", lambda x: ops.stencil_perks(
            x, spec=spec, steps=n, cached_rows=rows, sub_rows=64,
            fuse_steps=3)),
        ("stencil_tb_batched", lambda x: ops.stencil_perks_deep(
            x, spec=spec, steps=n, cached_rows=rows, fuse_steps=4)),
        ("stencil_resident_batched", lambda x: ops.stencil_resident(
            x, spec=spec, steps=n)),
    ]


def _lanes(b, shape, dtype, cuda, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b,) + shape).astype(np.float32)).to(cuda, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_batched_resident_kernels_lane_by_lane(name, dtype, cuda):
    spec = get_spec(name)
    for shape in LANE_SHAPES[spec.ndim]:
        for b in (3, 8):
            xs = _lanes(b, shape, dtype, cuda, seed=31 + b)
            want = ref.stencil_run(xs, spec, LANE_STEPS)
            for counter, run in _lane_kernels(spec):
                before = ops.launch_counts()[counter]
                got = run(xs)
                assert ops.launch_counts()[counter] == before + 1, counter
                assert torch.equal(got, want), (name, shape, b, counter)
                for i in range(b):
                    assert torch.equal(got[i], run(xs[i])), (counter, i)
                assert ops.launch_counts()[counter] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["2d5pt", "2ds25pt", "3d7pt", "3d13pt"])
def test_cuda_batched_lanes_that_differ_only_at_their_boundaries(name, dtype,
                                                                  cuda):
    """Every lane holds the same domain but its first and last rows, so a
    lane that read its neighbour's rows (a wrong lane offset, or a TMA map
    whose rows run on into the next lane) differs from its own launch."""
    spec = get_spec(name)
    shape = LANE_SHAPES[spec.ndim][0]
    b, k = 4, min(8 * spec.radius, shape[0] // 3)
    xs = _lanes(1, shape, dtype, cuda, seed=41).repeat((b,) + (1,) * len(shape))
    edge = _lanes(b, (2 * k,) + shape[1:], dtype, cuda, seed=42)
    xs[:, :k], xs[:, -k:] = edge[:, :k], edge[:, k:]
    want = ref.stencil_run(xs, spec, LANE_STEPS)
    tma = ops.launch_counts()["stencil_perks_deep_tma"]
    for counter, run in _lane_kernels(spec):
        got = run(xs)
        assert torch.equal(got, want), counter
        for i in range(b):
            assert torch.equal(got[i], run(xs[i])), (counter, i)
        assert not torch.equal(got[0], got[1])
    # the deep kernel took its rank-4 TMA maps, lanes and single launches
    if shape[-1] * xs.element_size() % 16 == 0:
        assert ops.launch_counts()["stencil_perks_deep_tma"] == tma + 1 + b


def test_cuda_one_lane_is_the_single_launch(cuda):
    """B = 1 ([1, ...]) launches the single launch's layout and gives its
    bits; it counts as a batched launch, a single launch does not."""
    for name in ("2d5pt", "3d7pt"):
        spec = get_spec(name)
        x = _lanes(1, LANE_SHAPES[spec.ndim][0], torch.float32, cuda, 51)[0]
        for counter, run in _lane_kernels(spec):
            before = ops.launch_counts()[counter]
            one = run(x)
            assert ops.launch_counts()[counter] == before
            assert torch.equal(run(x[None])[0], one), counter
            assert ops.launch_counts()[counter] == before + 1


def test_cuda_batches_the_card_cannot_hold_raise(cuda):
    spec = get_spec("2d5pt")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    many = torch.zeros((sms + 1, 16, 16), device=cuda)
    for _, run in _lane_kernels(spec):
        with pytest.raises(ValueError, match="co-resident CTA"):
            run(many)
    # the whole card holds the domain, two lanes' halves of it do not
    limit = (torch.cuda.get_device_properties(cuda)
             .shared_memory_per_block_optin - stencil2d.PERKS_STATIC_SMEM)
    per = stencil2d.rows_per_cta(8192, 4, 1, limit)
    H = (sms // 2) * per + 4
    x = _lanes(2, (H, 8192), torch.float32, cuda, 61)
    assert torch.equal(ops.stencil_resident(x[0], spec=spec, steps=3),
                       ref.stencil_run(x[0], spec, 3))
    with pytest.raises(ValueError, match="cannot keep"):
        ops.stencil_resident(x, spec=spec, steps=3)


@pytest.mark.parametrize("name,shape,b", [("2d5pt", (256, 520), 4),
                                          ("3d7pt", (48, 40, 44), 3)])
def test_cuda_batched_resident_plans_match_sequential(name, shape, b, cuda):
    """Every resident candidate the planner offers a batch runs in one
    launch, each lane bit-equal to ``execute_sequential`` of its plan."""
    from repro_torch.exec import BatchedProblem, execute_sequential
    spec = get_spec(name)
    xs = _lanes(b, shape, torch.float32, cuda, 71)
    insts = [StencilProblem(xs[i], spec, 9) for i in range(b)]
    bp = BatchedProblem.from_instances(insts)
    cands = [c for c in plan_candidates(bp) if c.tier == "resident"]
    assert cands
    before = ops.launch_counts()
    for c in cands:
        out = execute(bp, c)
        seq = execute_sequential(insts, dataclasses.replace(
            c, batch=1, problem=""))
        for i, w in enumerate(seq):
            assert torch.equal(out[i], w), (c, i)
    after = ops.launch_counts()
    batched = sum(after[k] - before[k] for k in (
        "stencil_perks_batched", "stencil_shallow_batched",
        "stencil_tb_batched", "stencil_resident_batched"))
    assert batched == len(cands)


# -- the CG slice ----------------------------------------------------------------

def _rhs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("name", SPD)
def test_cuda_spmv_kernels_match_plain_version(name, cuda):
    csr = generate(name)
    x = torch.from_numpy(_rhs(csr.shape[0], seed=11)).to(cuda)
    ell = csr.to_ell()
    data = torch.from_numpy(ell.data).to(cuda)
    cols = torch.from_numpy(ell.cols).to(cuda)
    torch.testing.assert_close(ops.spmv(data, cols, x),
                               ref.spmv_ell(data, cols, x), **SPMV_TOL)
    for c, sigma in ((8, 64), (32, 256)):
        op = SellOperator.from_matrix(csr.to_sell(c=c, sigma=sigma), cuda)
        args = (op.data, op.cols, op.slice_offsets, op.slice_k, x)
        torch.testing.assert_close(
            ops.spmv_sell(*args, c=c, k_max=op.k_max),
            ref.spmv_sell(*args, c=c, k_max=op.k_max), **SPMV_TOL)


def _sell(c, widths, seed, device):
    """A SELL-C layout of one slice per entry of ``widths`` (its slots a
    row), random values and columns, and its x."""
    g = np.random.default_rng(seed)
    k = np.asarray(widths, dtype=np.int32)
    offsets = np.concatenate([[0], np.cumsum(k * c)[:-1]]).astype(np.int32)
    n = len(widths) * c
    data = g.standard_normal(int(k.sum()) * c).astype(np.float32)
    cols = g.integers(0, n, data.shape).astype(np.int32)
    x = g.standard_normal(n).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (data, cols, offsets, k,
                                                     x)]


@pytest.mark.parametrize("c", [1, 8, 32, 33])
def test_cuda_spmv_sell_is_bit_equal_at_every_slice_width(c, cuda):
    """Slices of 1..33 slots, in the plain version's slot order."""
    data, cols, offsets, k, x = _sell(c, list(range(1, 34)), c, cuda)
    assert torch.equal(ops.spmv_sell(data, cols, offsets, k, x, c=c,
                                     k_max=33),
                       ref.spmv_sell(data, cols, offsets, k, x, c=c,
                                     k_max=33))


def test_cuda_spmv_sell_takes_misaligned_streams(cuda):
    data, cols, offsets, k, x = _sell(8, [3, 1, 7, 2, 5], 1, cuda)
    want = ref.spmv_sell(data, cols, offsets, k, x, c=8, k_max=7)
    bd = torch.empty(data.numel() + 1, dtype=data.dtype, device=cuda)
    bc = torch.empty(cols.numel() + 1, dtype=cols.dtype, device=cuda)
    bd[1:].copy_(data)
    bc[1:].copy_(cols)
    assert bd[1:].data_ptr() % 16 and bc[1:].data_ptr() % 16
    assert torch.equal(ops.spmv_sell(bd[1:], bc[1:], offsets, k, x, c=8,
                                     k_max=7), want)


@pytest.mark.parametrize("name", SPD)
def test_cuda_spmv_sell_is_bit_equal_on_the_registry(name, cuda):
    csr = generate(name)
    x = torch.from_numpy(_rhs(csr.shape[0], seed=12)).to(cuda)
    for c, sigma in ((8, 64), (32, 256)):
        op = SellOperator.from_matrix(csr.to_sell(c=c, sigma=sigma), cuda)
        args = (op.data, op.cols, op.slice_offsets, op.slice_k, x)
        assert torch.equal(ops.spmv_sell(*args, c=c, k_max=op.k_max),
                           ref.spmv_sell(*args, c=c, k_max=op.k_max)), c


@pytest.mark.parametrize("side", [16, 48, 101])
def test_cuda_cg_fused_matches_plain_version(side, cuda):
    ell = poisson2d(side).to_ell()
    n = side * side
    data = torch.from_numpy(ell.data).to(cuda)
    cols = torch.from_numpy(ell.cols).to(cuda)
    b = torch.from_numpy(_rhs(n, seed=side)).to(cuda)
    want_x, want_rr = ref.cg_run(data, cols, b, 30)
    for kw in (dict(resident_matrix=False), dict(resident_matrix=True),
               dict(resident_matrix=True, matrix_rows=n // 3)):
        x, rr = ops.cg(data, cols, b, iters=30, **kw)
        torch.testing.assert_close(x, want_x, **CG_TOL)
        torch.testing.assert_close(rr[0], want_rr, **CG_TOL)
        x2, rr2 = ops.cg(data, cols, b, iters=30, **kw)
        assert torch.equal(x, x2) and torch.equal(rr, rr2), "not repeatable"


def test_cuda_cg_fused_refuses_what_a_cta_does_not_hold(cuda):
    n = 4 * 2**20
    data = torch.zeros((n, 5), device=cuda)
    cols = torch.zeros((n, 5), dtype=torch.int32, device=cuda)
    b = torch.ones(n, device=cuda)
    with pytest.raises(ValueError, match="holds at most"):
        ops.cg(data, cols, b, iters=1, resident_matrix=False)
    with pytest.raises(TypeError, match="int32"):
        ops.spmv(data, cols.long(), b)


def test_cuda_cg_tiers_match_plain_version(cuda):
    csr = poisson2d(40)
    ell = csr.to_ell()
    b = _rhs(csr.shape[0], seed=3)
    p = CGProblem.from_ell(ell.data, ell.cols, b, 25, matrix=csr, device=cuda)
    want_x, want_rr = p.oracle()
    cands = plan_candidates(p)
    assert {c.policy for c in cands if c.tier == "resident"} == {"VEC", "MIX"}
    perks.clear_graphs()
    loop = None
    for pl in cands + [Plan(tier="device_loop"), Plan(tier="device_loop",
                                                      sync_every=7)]:
        x, rr = execute(p, pl)
        torch.testing.assert_close(x, want_x, **CG_TOL)
        torch.testing.assert_close(rr, want_rr, **CG_TOL)
        # the loop tiers run one step function (their dot is csrc/vdot.cu,
        # the oracle's torch.dot): the same bits on every loop tier
        if pl.tier != "resident":
            loop = (x, rr) if loop is None else loop
            assert torch.equal(x, loop[0]) and torch.equal(rr, loop[1]), pl
    assert perks.graph_cached(p.step_fn(), p.initial_state(), 25)
    before = ops.launch_counts()["spmv_ell"]
    execute(p, Plan(tier="device_loop"))        # a replay: no new launch
    assert ops.launch_counts()["spmv_ell"] == before
    perks.clear_graphs()
    op = SellOperator.from_matrix(csr.to_sell(c=32, sigma=256), cuda)
    q = CGProblem.from_matvec(op.matvec, b, 25, matrix=csr, device=cuda)
    before = ops.launch_counts()["spmv_sell"]
    for pl in plan_candidates(q):
        x, rr = execute(q, pl)
        torch.testing.assert_close(x, want_x, **CG_TOL)
    assert ops.launch_counts()["spmv_sell"] > before
    perks.clear_graphs()


def test_cuda_cg_tol_stops_early(cuda):
    csr = poisson2d(24)
    ell = csr.to_ell()
    p = CGProblem.from_ell(ell.data, ell.cols, _rhs(csr.shape[0]), 400,
                           matrix=csr, tol=1e-6, device=cuda)
    pl = plan(p)
    assert pl.sync_every == 25
    before = ops.launch_counts()["spmv_ell"]
    x, rr = execute(p, Plan(tier="device_loop", sync_every=pl.sync_every))
    launched = ops.launch_counts()["spmv_ell"] - before
    assert float(rr) < 1e-6 * float(p.initial_state()[3])
    assert 0 < launched < 200, launched      # stopped long before 400


# -- the Krylov slice -------------------------------------------------------------

def _hold(x, x32, x64):
    """A Krylov kernel's x against the plain float32 run x32 and a float64
    run x64: within twice the float32 run's distance from x64 plus 1e-5
    ||x64||, and at CG_TOL from x32 wherever x32 itself is within 1e-4 of
    x64 (in BiCGStab's erratic phase two float32 dot orders drift apart
    further than that; chip_smoke.py prints the spread)."""
    d = torch.linalg.vector_norm(x.double() - x64).item()
    d32 = torch.linalg.vector_norm(x32.double() - x64).item()
    assert d <= 2 * d32 + 1e-5 * torch.linalg.vector_norm(x64).item()
    if (x32.double() - x64).abs().max().item() < 1e-4:
        torch.testing.assert_close(x, x32, **CG_TOL)


def _convdiff(side, cuda, seed=0):
    from repro_torch.sparse.generate import convdiff2d
    csr = convdiff2d(side)
    ell = csr.to_ell()
    return (csr, torch.from_numpy(ell.data).to(cuda),
            torch.from_numpy(ell.cols).to(cuda),
            torch.from_numpy(_rhs(csr.shape[0], seed=seed)).to(cuda))


@pytest.mark.parametrize("side", [16, 48, 101])
def test_cuda_bicgstab_fused_matches_plain_version(side, cuda):
    _, data, cols, b = _convdiff(side, cuda, seed=side)
    n = b.shape[0]
    x32, rr32 = ref.bicgstab_run(data, cols, b, 40)
    x64, _ = ref.bicgstab_run(data.double(), cols, b.double(), 40)
    for kw in (dict(resident_matrix=False), dict(resident_matrix=True),
               dict(resident_matrix=True, matrix_rows=n // 3)):
        x, rr = ops.bicgstab(data, cols, b, iters=40, **kw)
        assert rr.shape == (1,) and bool(torch.isfinite(rr).all())
        _hold(x, x32, x64)
        x2, rr2 = ops.bicgstab(data, cols, b, iters=40, **kw)
        assert torch.equal(x, x2) and torch.equal(rr, rr2), "not repeatable"
    x, rr = ops.bicgstab(data, cols, b, iters=0)
    assert torch.equal(x, torch.zeros_like(b))
    torch.testing.assert_close(rr[0], torch.dot(b, b), rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind", ["cg", "bicgstab"])
def test_cuda_fused_krylov_repeats_bit_for_bit_and_in_a_graph(kind, cuda):
    """Calls in a row and replays of a captured CUDA graph give the same
    bits under every policy, short launches included: the tagged rounds'
    words are zeroed on the stream before every launch, so no round takes
    a tag that an earlier launch left."""
    if kind == "cg":
        ell = poisson2d(48).to_ell()
        data = torch.from_numpy(ell.data).to(cuda)
        cols = torch.from_numpy(ell.cols).to(cuda)
        b = torch.from_numpy(_rhs(data.shape[0], seed=5)).to(cuda)
        fused = ops.cg
    else:
        _, data, cols, b = _convdiff(48, cuda, seed=5)
        fused = ops.bicgstab
    n = b.shape[0]
    for iters in (0, 1, 30):
        for kw in (dict(resident_matrix=False), dict(resident_matrix=True),
                   dict(resident_matrix=True, matrix_rows=n // 3)):
            def run():
                return fused(data, cols, b, iters=iters, **kw)
            x, rr = run()
            for _ in range(2):
                x2, rr2 = run()
                assert torch.equal(x, x2) and torch.equal(rr, rr2), (iters, kw)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                gx, grr = run()
            for _ in range(3):
                graph.replay()
                torch.cuda.synchronize()
                assert torch.equal(gx, x) and torch.equal(grr, rr), (iters, kw)
                x2, rr2 = run()         # an eager call between replays
                assert torch.equal(x2, x) and torch.equal(rr2, rr)


@pytest.mark.parametrize("side,m", [(8, 8), (12, 16), (16, 8), (48, 16),
                                    (101, 31)])
def test_cuda_gmres_cycle_fused_matches_plain_version(side, m, cuda):
    """Sides 8 and 12 (n = 64, 144) give a grid wider than the rows: every
    CTA owns one row or none (two at most at 144), and still takes part in
    every round."""
    import functools
    _, data, cols, b = _convdiff(side, cuda, seed=side)
    x0 = 0.1 * torch.from_numpy(_rhs(b.shape[0], seed=1)).to(cuda)
    want = ref.gmres_cycle_update(x0, b, functools.partial(ref.spmv_ell,
                                                           data, cols), m)
    got = ops.gmres_cycle(data, cols, x0, b, m=m)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **CG_TOL)
    V = got[0]
    eye = torch.eye(m + 1, device=cuda)
    assert (V @ V.T - eye).abs().max().item() < 1e-4
    again = ops.gmres_cycle(data, cols, x0, b, m=m)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_cuda_gmres_cycle_fused_arnoldi_breakdown(cuda):
    """An exact breakdown at the first step: A diagonal and b on one axis,
    so A v_0 = d v_0 and hn = 0; inv is 0, every later v and column of H
    is 0, and the Givens solve gives the plain version's answer."""
    import functools
    n = 300
    d = torch.arange(2, n + 2, dtype=torch.float32)
    data = torch.zeros((n, 3))
    data[:, 0] = d
    cols = torch.arange(n, dtype=torch.int32)[:, None].repeat(1, 3)
    b = torch.zeros(n)
    b[150] = 4.0
    data, cols, b = data.to(cuda), cols.to(cuda), b.to(cuda)
    x0 = torch.zeros_like(b)
    want = ref.gmres_cycle_update(x0, b, functools.partial(ref.spmv_ell,
                                                           data, cols), 8)
    V, H, beta, x = ops.gmres_cycle(data, cols, x0, b, m=8)
    for g, w in zip((V, H, beta, x), want):
        torch.testing.assert_close(g, w, **CG_TOL)
    assert float(beta[0]) == 4.0 and float(H[0, 0]) == 152.0
    assert (H[1:, 0] == 0).all() and (H[:, 1:] == 0).all()
    assert (V[1:] == 0).all()
    assert float(x[150]) == pytest.approx(4.0 / 152.0)


def test_cuda_gmres_cycle_fused_repeats_in_a_graph(cuda):
    """Calls in a row and replays of a captured CUDA graph give the same
    bits: the launch zeroes its 2 x 32 tag words a CTA on the stream, so
    no round of a replay takes a tag an earlier launch left."""
    _, data, cols, b = _convdiff(48, cuda, seed=5)
    x0 = 0.1 * torch.from_numpy(_rhs(b.shape[0], seed=2)).to(cuda)
    for m in (1, 16):
        def run():
            return ops.gmres_cycle(data, cols, x0, b, m=m)
        want = run()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = run()
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), m
            again = run()           # an eager call between replays
            assert all(torch.equal(a, w) for a, w in zip(again, want)), m


def test_cuda_krylov_kernels_refuse_what_a_cta_does_not_hold(cuda):
    n = 4 * 2**20
    data = torch.zeros((n, 5), device=cuda)
    cols = torch.zeros((n, 5), dtype=torch.int32, device=cuda)
    b = torch.ones(n, device=cuda)
    with pytest.raises(ValueError, match="holds at most"):
        ops.bicgstab(data, cols, b, iters=1, resident_matrix=False)
    with pytest.raises(ValueError, match="holds at most"):
        ops.gmres_cycle(data, cols, b, b, m=16)
    small = poisson2d(8).to_ell()
    d = torch.from_numpy(small.data).to(cuda)
    c = torch.from_numpy(small.cols).to(cuda)
    with pytest.raises(ValueError, match="m must be"):
        ops.gmres_cycle(d, c, b[:64], b[:64], m=32)


@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_cuda_krylov_tiers_match_plain_version(kind, cuda):
    from repro_torch.exec import BiCGStabProblem, GMRESProblem
    csr, data, cols, b = _convdiff(40, cuda, seed=2)
    if kind == "bicgstab":
        p = BiCGStabProblem.from_ell(data, cols, b, 40, matrix=csr,
                                     device=cuda)
        x64, _ = ref.bicgstab_run(data.double(), cols, b.double(), 40)
    else:
        p = GMRESProblem.from_ell(data, cols, b, 3, m=12, matrix=csr,
                                  device=cuda)
        x64, _ = ref.gmres_run(data.double(), cols, b.double(), 3, 12)
    want_x, want_rr = p.oracle()
    cands = plan_candidates(p)
    assert {c.policy for c in cands if c.tier == "resident"} == (
        {"VEC", "MIX"} if kind == "bicgstab" else {"MIX"})
    perks.clear_graphs()
    loop = None
    for pl in cands + [Plan(tier="device_loop"), Plan(tier="device_loop",
                                                      sync_every=7)]:
        x, rr = execute(p, pl)
        _hold(x, want_x, x64)
        # one step function on every loop tier: the same bits
        if pl.tier != "resident":
            loop = (x, rr) if loop is None else loop
            assert torch.equal(x, loop[0]) and torch.equal(rr, loop[1]), pl
    name = "bicgstab_fused" if kind == "bicgstab" else "gmres_cycle_fused"
    before = ops.launch_counts()[name]
    execute(p, next(c for c in cands if c.tier == "resident"))
    assert ops.launch_counts()[name] == before + (1 if kind == "bicgstab"
                                                  else 3)
    perks.clear_graphs()


def test_cuda_gmres_device_loop_keeps_its_graph(cuda):
    from repro_torch.exec import GMRESProblem
    csr, data, cols, b = _convdiff(32, cuda, seed=4)
    p = GMRESProblem.from_ell(data, cols, b, 2, m=8, matrix=csr, device=cuda)
    perks.clear_graphs()
    first = execute(p, Plan(tier="device_loop"))
    assert perks.graph_cached(p.step_fn(), p.initial_state(), 2)
    before = ops.launch_counts()["spmv_ell"]
    second = execute(p, Plan(tier="device_loop"))   # a replay: no launch
    assert ops.launch_counts()["spmv_ell"] == before
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                           second[1])
    x64, _ = ref.gmres_run(data.double(), cols, b.double(), 2, 8)
    _hold(first[0], p.oracle()[0], x64)
    perks.clear_graphs()


def test_cuda_changed_problems_replay_the_kept_graph(cuda):
    """The second mixed-precision execute and the later solve_refined
    rounds replay the first run's graph: no launch, and the same bits as
    a fresh capture."""
    from repro_torch.exec import BiCGStabProblem, solve_refined
    csr, data, cols, b = _convdiff(24, cuda, seed=6)
    p = BiCGStabProblem.from_ell(data, cols, b, 30, matrix=csr, device=cuda)
    mixed = Plan(tier="device_loop", precision="mixed")
    perks.clear_graphs()
    first, rr1 = execute(p, mixed)
    before = ops.launch_counts()["spmv_ell"]
    second, rr2 = execute(p, mixed)
    assert ops.launch_counts()["spmv_ell"] == before, "captured again"
    assert torch.equal(first, second) and torch.equal(rr1, rr2)
    q = p.with_rhs(b.flip(0))
    fresh = BiCGStabProblem.from_ell(data, cols, b.flip(0), 30, matrix=csr,
                                     device=cuda)
    xq, _ = execute(q, mixed)                       # a replay
    assert ops.launch_counts()["spmv_ell"] == before
    perks.clear_graphs()
    xf, _ = execute(fresh, mixed)                   # a fresh capture
    assert ops.launch_counts()["spmv_ell"] > before
    assert torch.equal(xq, xf)
    perks.clear_graphs()
    x2, _ = solve_refined(p, mixed, rounds=2)
    launched = ops.launch_counts()["spmv_ell"]
    x3, _ = solve_refined(p, mixed, rounds=3)
    # the third round's execute replays, only the residual SpMVs launch
    assert ops.launch_counts()["spmv_ell"] == launched + 3
    perks.clear_graphs()


def test_cuda_mixed_precision_runs_the_loop_tiers(cuda):
    from repro_torch.exec import BiCGStabProblem
    csr, data, cols, b = _convdiff(24, cuda, seed=5)
    p = BiCGStabProblem.from_ell(data, cols, b, 30, matrix=csr, device=cuda)
    xu, _ = execute(p, Plan(tier="host_loop"))
    xm, _ = execute(p, Plan(tier="host_loop", precision="mixed"))
    xd, _ = execute(p, Plan(tier="device_loop", precision="mixed"))
    assert torch.equal(xm, xd)
    assert (xm - xu).abs().max().item() <= 1e-3 * xu.abs().max().item()
    perks.clear_graphs()


# -- the ML serving slice: ssm_scan, decode_attention, the decode tiers ------

# The reference's tolerances (tests/test_kernels_linalg.py): the SSD scan
# at 1e-3 (float32) / 5e-2 (bf16), decode attention at rtol 1e-4 / atol
# 1e-5 (float32) / 5e-2 (bf16).
SSM_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
DECODE_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
              torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}


def _ssd_inputs(bsz, t, h, p, n, dtype, device, seed=0):
    g = np.random.default_rng(seed)

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    x = put(0.5 * g.standard_normal((bsz, t, h, p))).to(dtype)
    dt = torch.nn.functional.softplus(
        put(g.standard_normal((bsz, t, h)))).to(dtype)
    a = -torch.exp(put(g.standard_normal(h)))
    b = put(0.5 * g.standard_normal((bsz, t, n))).to(dtype)
    c = put(0.5 * g.standard_normal((bsz, t, n))).to(dtype)
    d = put(g.standard_normal(h))
    return x, dt, a, b, c, d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,chunk", [(64, 16), (64, 64), (60, 15), (64, 15),
                                     (13, 8), (200, 128), (37, 1)])
def test_cuda_ssd_scan_matches_plain_version(t, chunk, dtype, cuda):
    x, dt, a, b, c, d = _ssd_inputs(2, t, 4, 8, 16, dtype, cuda, seed=t)
    got = ops.ssd_scan(x, dt, a, b, c, d, chunk=chunk)
    want = ops.ssd_scan(*(v.cpu() for v in (x, dt, a, b, c, d)), chunk=chunk)
    tol = SSM_TOL[dtype]
    assert got.dtype == dtype and got.shape == x.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


# The tensor-core scan at its tile edges: a column slice cut short (P = 40),
# a state that is not a multiple of 8 (N = 20), a head count that is not a
# multiple of 4 or 8 (H = 6), several sequences with a ragged last
# chunk (B = 3, T = 1000), and mamba2-780m's widths; (B, T, H, P, N, chunk).
SSD_EDGES = [(2, 200, 4, 40, 16, 64), (2, 130, 4, 16, 20, 32),
             (2, 100, 6, 16, 16, 16), (3, 1000, 4, 16, 16, 128),
             (1, 1024, 48, 64, 128, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_EDGES,
                         ids=["P40", "N20", "H6", "B3T1000", "mamba2"])
def test_cuda_ssd_scan_tile_edges_and_graph_replay(shape, dtype, cuda):
    bsz, t, h, p, n, chunk = shape
    x, dt, a, b, c, d = _ssd_inputs(bsz, t, h, p, n, dtype, cuda, seed=t + n)
    got = ops.ssd_scan(x, dt, a, b, c, d, chunk=chunk)
    want = torch.stack([ref.ssm_scan(x[i].float(), dt[i].float(), a,
                                     b[i].float(), c[i].float(), d)
                        for i in range(bsz)])
    tol = SSM_TOL[dtype]
    assert got.dtype == dtype and got.shape == x.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.cpu().numpy(), rtol=tol, atol=tol)
    # a replay inside a CUDA graph gives the eager call's bits (no atomics)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.ssd_scan(x, dt, a, b, c, d, chunk=chunk)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = ops.ssd_scan(x, dt, a, b, c, d, chunk=chunk)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 2), (4, 1), (14, 2)])
@pytest.mark.parametrize("s", [96, 128, 700, 3000])
def test_cuda_decode_attention_matches_plain_version(hq, hkv, s, dtype, cuda):
    g = np.random.default_rng(s + hq)
    bsz, dim = 3, 32 if hq != 14 else 64

    def put(*shape):
        return torch.from_numpy(
            g.standard_normal(shape).astype(np.float32)).to(cuda).to(dtype)

    q, k, v = put(bsz, hq, dim), put(bsz, s, hkv, dim), put(bsz, s, hkv, dim)
    length = torch.tensor([s, 1, max(1, s // 3)], dtype=torch.int32,
                          device=cuda)
    for ln in (None, length):
        got = ops.decode_attention(q, k, v, length=ln)
        want = ref.decode_attention(q.float(), k.float(), v.float(),
                                    length=ln)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.cpu().numpy(), **DECODE_TOL[dtype])


@pytest.mark.parametrize("dim", [64, 80, 128, 256])
@pytest.mark.parametrize("hq,hkv", [(16, 16), (40, 8), (14, 2), (64, 4)])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 160, 1000])
def test_cuda_decode_tensor_cores_match_plain_version(dim, hq, hkv, s, cuda):
    """The bf16 tensor-core kernel against the plain version on float32
    copies, under chip_smoke's bf16 rule: rtol 5e-2 and an atol of 5e-2 x
    the output's rms."""
    g = np.random.default_rng(dim + 3 * hq + 7 * s)

    def put(*shape):
        return torch.from_numpy(g.standard_normal(shape).astype(
            np.float32)).to(cuda).to(torch.bfloat16)

    q, k, v = put(2, hq, dim), put(2, s, hkv, dim), put(2, s, hkv, dim)
    tol = DECODE_TOL[torch.bfloat16]
    for ln in (None, 1, s // 3 + 1, s):
        length = None if ln is None else torch.tensor(
            [ln, s], dtype=torch.int32, device=cuda)
        before = ops.launch_counts()
        got = ops.decode_attention(q, k, v, length=length)
        after = ops.launch_counts()
        assert after["decode_attention_tc"] == \
            before["decode_attention_tc"] + 1
        assert after["decode_attention_cc"] == before["decode_attention_cc"]
        want = ref.decode_attention(q.float(), k.float(), v.float(),
                                    length=length)
        rms = want.double().pow(2).mean().sqrt().item()
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.cpu().numpy(), rtol=tol["rtol"],
                                   atol=tol["atol"] * rms)


def test_cuda_decode_runs_the_kernel_its_dtype_and_shape_name(cuda):
    g = np.random.default_rng(5)

    def put(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(g.standard_normal(shape).astype(
            np.float32)).to(cuda).to(dtype)

    flat = put(2 * 40 * 2 * 64 + 1)
    cases = [  # (q, k, v, the kernel)
        (put(2, 14, 64), put(2, 40, 2, 64), put(2, 40, 2, 64),
         "decode_attention_tc"),
        (put(2, 14, 64, dtype=torch.float32),
         put(2, 40, 2, 64, dtype=torch.float32),
         put(2, 40, 2, 64, dtype=torch.float32), "decode_attention_cc"),
        (put(2, 14, 72), put(2, 40, 2, 72), put(2, 40, 2, 72),
         "decode_attention_cc"),
        # k a view 2 bytes past a 16-byte boundary
        (put(2, 14, 64), flat[1:].view(2, 40, 2, 64), put(2, 40, 2, 64),
         "decode_attention_cc"),
    ]
    for q, k, v, kernel in cases:
        before = ops.launch_counts()
        got = ops.decode_attention(q, k, v)
        delta = {n: c - before[n] for n, c in ops.launch_counts().items()
                 if c != before[n]}
        assert delta == {"decode_attention": 1, kernel: 1}
        want = ref.decode_attention(q.float(), k.float(), v.float())
        tol = DECODE_TOL[q.dtype]
        rms = want.double().pow(2).mean().sqrt().item()
        np.testing.assert_allclose(
            got.float().cpu().numpy(), want.cpu().numpy(), rtol=tol["rtol"],
            atol=tol["atol"] * (rms if q.dtype == torch.bfloat16 else 1.0))


def _ell(k, n, seed, device):
    g = np.random.default_rng(seed)
    data = g.standard_normal((n, k)).astype(np.float32)
    cols = g.integers(0, n, (n, k)).astype(np.int32)
    x = g.standard_normal(n).astype(np.float32)
    return (torch.from_numpy(a).to(device) for a in (data, cols, x))


@pytest.mark.parametrize("k", [0, 1, 3, 5, 7, 9])
@pytest.mark.parametrize("n", [1, 255, 257, 4099])
def test_cuda_spmv_ell_is_bit_equal_to_plain_version(k, n, cuda):
    data, cols, x = _ell(k, n, 100 * k + n, cuda)
    assert torch.equal(ops.spmv(data, cols, x), ref.spmv_ell(data, cols, x))


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
def test_cuda_spmv_ell_takes_misaligned_planes(k, cuda):
    n = 4099
    data, cols, x = _ell(k, n, k, cuda)
    # data and cols as views one element (4 bytes) past a 16-byte boundary
    bd = torch.empty(n * k + 1, dtype=torch.float32, device=cuda)
    bc = torch.empty(n * k + 1, dtype=torch.int32, device=cuda)
    bd[1:].copy_(data.reshape(-1))
    bc[1:].copy_(cols.reshape(-1))
    dv, cv = bd[1:].view(n, k), bc[1:].view(n, k)
    assert dv.data_ptr() % 16 and cv.data_ptr() % 16
    want = ref.spmv_ell(data, cols, x)
    assert torch.equal(ops.spmv(dv, cv, x), want)
    assert torch.equal(ops.spmv(dv, cols, x), want)
    assert torch.equal(ops.spmv(data, cv, x), want)


@pytest.mark.parametrize("name", sorted(SPD + nonsymmetric_names()))
def test_cuda_spmv_ell_is_bit_equal_on_the_registry(name, cuda):
    """Every ELL width of the registry (5 to 328 slots a row: the template
    widths and the generic loop)."""
    csr = generate(name)
    ell = csr.to_ell()
    data = torch.from_numpy(ell.data).to(cuda)
    cols = torch.from_numpy(ell.cols).to(cuda)
    x = torch.from_numpy(_rhs(csr.shape[0], seed=3)).to(cuda)
    assert torch.equal(ops.spmv(data, cols, x), ref.spmv_ell(data, cols, x))


def _smoke_decode(cuda, n_steps=7, eos_id=None):
    from repro_torch.configs import get_smoke_config
    from repro_torch.exec import DecodeAttentionProblem
    from repro_torch.models.lm import Model
    cfg = get_smoke_config("qwen2-0.5b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 6)).astype(np.int32)).to(cuda)
    logits, cache = model.prefill(model.compute_params(params),
                                  {"tokens": prompts},
                                  cache_seq=6 + n_steps + 1)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    return DecodeAttentionProblem(model=model, params=params, cache=cache,
                                  first_tokens=first, n_steps=n_steps,
                                  eos_id=eos_id)


def test_cuda_decode_tiers_token_identical(cuda):
    prob = _smoke_decode(cuda)
    k0 = prob.cache["k"].clone()
    want, cache = prob.oracle()
    ops.reset_launch_counts()
    for tier in ("host_loop", "device_loop", "device_loop", "resident",
                 "resident"):
        toks, got = execute(prob, Plan(tier=tier))
        assert torch.equal(toks, want), tier
        assert torch.equal(got["k"], cache["k"]), tier
        assert int(got["pos"]) == int(cache["pos"])
    assert torch.equal(prob.cache["k"], k0), "the problem's cache was written"
    # the host loop launches every step; the device loop's first run
    # captures (its warm-up step included), its replay and the resident
    # tier (the same step, the same kept graph) launch nothing
    layers = prob.model.cfg.n_layers
    assert ops.launch_counts()["decode_attention"] == 7 * layers + 8 * layers
    perks.clear_graphs()


def test_cuda_decode_eos_and_chunked_device_loop(cuda):
    base = _smoke_decode(cuda, n_steps=8)
    want = base.oracle()[0]
    eos = int(want[0, 0])
    prob = _smoke_decode(cuda, n_steps=8, eos_id=eos)
    done = (want == eos).all(dim=0).nonzero()
    k = int(done[0]) + 1 if len(done) else 8    # steps up to the stop
    assert all(p.tier != "resident" for p in plan_candidates(prob))
    k0 = prob.cache["k"].clone()
    for p in (Plan(tier="device_loop", sync_every=3), plan(prob)):
        toks, _ = execute(prob, p)
        assert torch.equal(toks[:, :k], want[:, :k])
    # the chunked device loop's captures wrote no slot of the problem's cache
    assert torch.equal(prob.cache["k"], k0)
    perks.clear_graphs()


def test_cuda_engine_modes_token_identical(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import Model
    from repro_torch.runtime.server import Engine, Request, ServeConfig
    cfg = get_smoke_config("qwen2-0.5b")
    model = Model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    outs = []
    for persistent in (True, False):
        eng = Engine(model, params, ServeConfig(max_batch=4,
                                                persistent=persistent))
        for batch in range(2):
            rng = np.random.default_rng(3)
            for n in (8, 5, 8, 3):
                eng.submit(Request(prompt=rng.integers(0, cfg.vocab, n,
                                                       dtype=np.int32),
                                   max_new_tokens=6))
            before = ops.launch_counts()["decode_attention"]
            out, stats = eng.run_batch()
            launched = ops.launch_counts()["decode_attention"] - before
            assert out.shape == (4, 6)
            if persistent and batch:
                assert launched == 0, "the kept decode graph was not replayed"
            if not persistent:
                assert launched == 5 * cfg.n_layers
            outs.append(out)
    for out in outs[1:]:
        np.testing.assert_array_equal(outs[0], out)
    perks.clear_graphs()


def test_cuda_ssm_tiers_match_oracle(cuda):
    from repro_torch.exec import SSMScanProblem
    x, dt, a, b, c, d = _ssd_inputs(1, 60, 3, 8, 16, torch.float32, cuda)
    prob = SSMScanProblem(x[0], dt[0], a, b[0], c[0], d, chunk=16,
                          device=cuda)
    want = prob.oracle()
    ops.reset_launch_counts()
    for tier in ("host_loop", "device_loop", "device_loop", "resident"):
        y = execute(prob, Plan(tier=tier))
        np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=tier)
    assert ops.launch_counts()["ssm_scan"] == 1
    assert plan(prob).tier == "resident"
    perks.clear_graphs()


# -- the SSM and hybrid families: the scan's final state, prefill and decode --

# (H, P, N): mamba2-780m's and zamba2-1.2b's SSD widths
SSD_MODEL_WIDTHS = {"mamba2": (48, 64, 128), "zamba2": (64, 64, 64)}


@pytest.mark.parametrize("t", [256, 200])
@pytest.mark.parametrize("widths", sorted(SSD_MODEL_WIDTHS))
def test_cuda_ssd_scan_final_state(widths, t, cuda):
    """ssd_scan(return_state=True) at both models' SSD widths (float32
    streams, B = 2, chunk 128; T = 200 leaves a ragged last chunk): y and the
    final state against the plain version, y bit for bit the launch's
    without the state."""
    h, p, n = SSD_MODEL_WIDTHS[widths]
    x, dt, a, b, c, d = _ssd_inputs(2, t, h, p, n, torch.float32, cuda,
                                    seed=t + n)
    before = ops.launch_counts()
    y, hf = ops.ssd_scan(x, dt, a, b, c, d, chunk=128, return_state=True)
    y0 = ops.ssd_scan(x, dt, a, b, c, d, chunk=128)
    after = ops.launch_counts()
    assert after["ssm_scan"] - before["ssm_scan"] == 2
    assert after["ssm_scan_state"] - before["ssm_scan_state"] == 1
    assert torch.equal(y, y0)
    assert hf.shape == (2, h, n, p) and hf.dtype == torch.float32
    wy, wh = ops.ssd_scan(*(v.cpu() for v in (x, dt, a, b, c, d)),
                          chunk=128, return_state=True)
    tol = SSM_TOL[torch.float32]
    np.testing.assert_allclose(y.cpu().numpy(), wy.numpy(), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(hf.cpu().numpy(), wh.numpy(), rtol=tol,
                               atol=tol)


def _smoke_pair(arch, cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import Model
    from repro_torch.nn.param import tree_map
    model = Model(dataclasses.replace(get_smoke_config(arch),
                                      compute_dtype=torch.float32))
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    return model, params, tree_map(torch.Tensor.cpu, params)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_cuda_ssm_model_prefill_and_decode_match_cpu(arch, cuda):
    """The smoke config in float32 on the card (the scan kernel on its
    prefill, decode attention on the hybrid's) against the CPU run on the
    same weights: logits and every cache leaf, then three decode steps."""
    model, params, cparams = _smoke_pair(arch, cuda)
    # 64: a multiple of the smoke configs' chunk (16) and q_chunk (32)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab, (2, 64)).astype(np.int32))
    before = ops.launch_counts()["ssm_scan_state"]
    lg, cache = model.prefill(params, {"tokens": prompts.to(cuda)},
                              cache_seq=68)
    assert ops.launch_counts()["ssm_scan_state"] - before == (
        model.cfg.n_layers)
    lh, cache_h = model.prefill(cparams, {"tokens": prompts}, cache_seq=68)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lg.cpu().numpy(), lh.numpy(), **tol)
    for key in cache_h:
        np.testing.assert_allclose(cache[key].cpu().numpy(),
                                   cache_h[key].numpy(), err_msg=key, **tol)
    tok = torch.argmax(lh, -1).to(torch.int32)
    for _ in range(3):
        lg, cache = model.decode_step(params, cache, tok.to(cuda))
        lh, cache_h = model.decode_step(cparams, cache_h, tok)
        np.testing.assert_allclose(lg.cpu().numpy(), lh.numpy(), **tol)
        tok = torch.argmax(lh, -1).to(torch.int32)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_cuda_ssm_decode_tiers_token_identical(arch, cuda):
    """DecodeAttentionProblem on every tier: the kept graph advances the
    conv windows and states in place from its own copy (its capture's
    warm-up step on another copy), so every tier gives the oracle's tokens
    and final cache, and the problem's cache is never written."""
    from repro_torch.exec import DecodeAttentionProblem
    model, params, _ = _smoke_pair(arch, cuda)
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        0, model.cfg.vocab, (2, 32)).astype(np.int32)).to(cuda)
    logits, cache = model.prefill(params, {"tokens": prompts}, cache_seq=40)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    prob = DecodeAttentionProblem(model=model, params=params, cache=cache,
                                  first_tokens=first, n_steps=7)
    before = {k: t.clone() for k, t in cache.items()}
    want, wcache = prob.oracle()
    for tier in ("host_loop", "device_loop", "device_loop", "resident",
                 "resident"):
        toks, got = execute(prob, Plan(tier=tier))
        assert torch.equal(toks, want), tier
        for key in wcache:
            assert torch.equal(got[key], wcache[key]), (tier, key)
    for key, t in before.items():
        assert torch.equal(prob.cache[key], t), key
    perks.clear_graphs()


# -- batched launches: B instances in one launch ---------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_batched_stencil_step_is_bit_equal_to_single_launches(
        name, dtype, cuda):
    spec = get_spec(name)
    for b in (1, 3):
        xs = torch.stack([torch.from_numpy(_domain(spec, seed=s))
                          for s in range(b)]).to(cuda, dtype)
        before = ops.launch_counts()["stencil_baseline_step"]
        got = ops.stencil_baseline_step(xs, spec=spec)
        assert ops.launch_counts()["stencil_baseline_step"] - before == 1
        for i in range(b):
            assert torch.equal(got[i], ops.stencil_baseline_step(xs[i],
                                                                 spec=spec))
        assert torch.equal(got, ref.stencil_step(xs, spec))


@pytest.mark.parametrize("b", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [0, 3, 5, 7])
def test_cuda_batched_spmv_ell_is_bit_equal_to_single_launches(b, k, cuda):
    rng = np.random.default_rng(k + 10 * b)
    n = 1031
    data = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, n, (n, k)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
    data, cols, x = data.to(cuda), cols.to(cuda), x.to(cuda)
    before = ops.launch_counts()["spmv_ell"]
    got = ops.spmv(data, cols, x)
    assert ops.launch_counts()["spmv_ell"] - before == 1
    assert got.shape == (b, n)
    for i in range(b):
        assert torch.equal(got[i], ops.spmv(data, cols, x[i]))
    assert torch.equal(got, ref.spmv_ell(data, cols, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [0, 1, 1000, 65536, 262145])
def test_cuda_vdot_lanes_are_bit_equal_to_single_launches(n, dtype, cuda):
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.standard_normal((5, n))).to(cuda, dtype)
    c = torch.from_numpy(rng.standard_normal((5, n))).to(cuda, dtype)
    before = ops.launch_counts()["vdot"]
    got = ops.vdot(a, c)
    assert ops.launch_counts()["vdot"] - before == 1
    for i in range(5):
        one = ops.vdot(a[i].clone(), c[i].clone())
        assert one.dim() == 0 and torch.equal(got[i], one)
    if dtype == torch.float64:
        _hold_float64_sums(a, c, got)
    else:
        want = (a.double() * c.double()).sum(-1)
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-4)
    # repeated launches give the same bits (the ticket counters reset)
    assert torch.equal(ops.vdot(a, c), got)


def test_cuda_vdot_streams_and_graphs_keep_their_own_counters(cuda):
    """Launches in flight at once on two streams, and a captured launch
    replayed beside them, never take each other's tickets: each gives the
    bits of a launch alone."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((8, 1 << 20)).astype(
        np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal((8, 1 << 20)).astype(
        np.float32)).to(cuda)
    want = ops.vdot(a, c)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        in_graph = ops.vdot(a, c)
    main = torch.cuda.current_stream()
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    assert s1.cuda_stream != s2.cuda_stream
    outs = []
    for _ in range(20):
        s1.wait_stream(main)
        s2.wait_stream(main)
        with torch.cuda.stream(s1):
            o1 = ops.vdot(a, c)
        with torch.cuda.stream(s2):
            graph.replay()
        o0 = ops.vdot(a, c)          # beside both
        main.wait_stream(s1)
        main.wait_stream(s2)
        outs += [o0, o1, in_graph.clone()]
    torch.cuda.synchronize()
    for got in outs:
        assert torch.equal(got, want)


def _hold_float64_sums(a, c, got):
    """float64 lanes against the correctly rounded sum of the same float64
    products (``math.fsum``), within 1e-12 of the sum of their magnitudes:
    a kernel that loaded doubles and added in float32 would miss it by
    five orders of magnitude or more."""
    a, c = a.cpu().numpy(), c.cpu().numpy()
    for i in range(a.shape[0]):
        prods = a[i] * c[i]
        want = math.fsum(prods)
        assert abs(got[i].item() - want) <= 1e-12 * np.abs(prods).sum(), i


@pytest.mark.parametrize("n", [3, 1000, 262145])
def test_cuda_vdot_float64_keeps_what_cancels_in_float32(n, cuda):
    """The mixed-precision dot (``compensated_vdot``) rests on vdot's
    float64 lanes: +2^26 and -2^26 around unit terms cancel exactly in
    float64, while a float32 sum (ulp 8 at 2^26) drops the unit terms."""
    from repro_torch.exec.precision import compensated_vdot
    rng = np.random.default_rng(n)
    a, c = rng.standard_normal((2, 2, n))
    a[1, 0], a[1, -1], c[1, 0], c[1, -1] = 2.0 ** 26, -2.0 ** 26, 1.0, 1.0
    a, c = torch.from_numpy(a).to(cuda), torch.from_numpy(c).to(cuda)
    got = ops.vdot(a, c)
    _hold_float64_sums(a, c, got)
    # the mixed dot of float32 vectors: a float64 sum of exact products,
    # one rounding to float32 (a float32 sum would be off by the lost
    # unit terms, about sqrt(n))
    a32, c32 = a[1].float(), c[1].float()
    want = np.float32(math.fsum(a32.double().cpu().numpy()
                                * c32.double().cpu().numpy()))
    got32 = compensated_vdot(a32, c32)
    assert got32.dtype == torch.float32
    assert abs(got32.item() - want) <= abs(np.spacing(want))


# Every lane width the kernel is built for, padded widths (3, 5, 31) and
# full ones; an n that is a multiple of neither the grid (132 CTAs) nor
# any width; K = 5 and, through the general-K row path, K = 7.
BATCH_CG_LANES = [1, 2, 3, 4, 5, 8, 16, 31, 32]
BATCH_CG_OPERATORS = {"poisson2d(47)": lambda: poisson2d(47),
                      "poisson3d(13)": lambda: poisson3d(13)}


@pytest.mark.parametrize("operator, iters", [
    ("poisson2d(47)", 40), ("poisson3d(13)", 30), ("poisson2d(47)", 0),
    ("poisson2d(47)", 1)])
@pytest.mark.parametrize("policy", ["VEC", "partial MIX", "MIX"])
@pytest.mark.parametrize("b", BATCH_CG_LANES)
def test_cuda_batched_cg_fused_is_bit_equal_to_single_launches(
        b, policy, operator, iters, cuda):
    ell = BATCH_CG_OPERATORS[operator]().to_ell()
    data = torch.from_numpy(ell.data).to(cuda)
    cols = torch.from_numpy(ell.cols).to(cuda)
    n = data.shape[0]
    rows = {"VEC": 0, "partial MIX": n // 3, "MIX": n}[policy]
    kw = dict(iters=iters, matrix_rows=rows, resident_matrix=rows > 0)
    rng = np.random.default_rng(7 + b)
    bs = torch.from_numpy(rng.standard_normal((b, n)).astype(
        np.float32)).to(cuda)
    x, rr = ops.cg(data, cols, bs, **kw)
    assert x.shape == (b, n) and rr.shape == (b,)
    for i in range(b):
        x1, rr1 = ops.cg(data, cols, bs[i].clone(), **kw)
        assert torch.equal(x[i], x1) and torch.equal(rr[i], rr1[0]), i
        xw, rrw = ref.cg_run(data, cols, bs[i], iters)
        torch.testing.assert_close(x[i], xw, **CG_TOL)
        torch.testing.assert_close(rr[i], rrw, **CG_TOL)


def test_cuda_cg_fused_static_smem_is_the_planners(cuda):
    """The planner fits batched resident plans to the H100's per-block
    shared memory less ``cg_fused.STATIC_SMEM_BYTES``; the card and the
    built kernel must give that limit."""
    import ctypes
    from repro_torch.core.hardware import H100
    from repro_torch.kernels import _build, cg_fused as kcg
    lib = _build.load("cg_fused")
    optin, static = ctypes.c_int(), ctypes.c_int()
    _build.check(lib.cg_fused_smem(ctypes.byref(optin), ctypes.byref(static)),
                 "cg_fused_smem")
    assert optin.value == H100.smem_per_block
    assert static.value == kcg.STATIC_SMEM_BYTES


def test_cuda_batched_cg_step_launches_what_one_step_launches(cuda):
    from repro_torch.exec import BatchedProblem, execute_sequential
    ell = poisson2d(32).to_ell()
    data = torch.from_numpy(ell.data).to(cuda)     # one operator, shared
    cols = torch.from_numpy(ell.cols).to(cuda)
    rng = np.random.default_rng(3)
    insts = [CGProblem.from_ell(data, cols,
                                rng.standard_normal(ell.data.shape[0]).astype(
                                    np.float32), 7, device=cuda)
             for _ in range(4)]
    bp = BatchedProblem.from_instances(insts)
    ops.reset_launch_counts()
    out = execute(bp, Plan(tier="host_loop", batch=4))
    counts = ops.launch_counts()
    assert counts["spmv_ell"] == 7 and counts["vdot"] == 14
    for (x, rr), (xs, rrs) in zip(bp.split(out), execute_sequential(
            insts, Plan(tier="host_loop"))):
        assert torch.equal(x, xs) and torch.equal(rr, rrs)
    for tier in ("device_loop", "resident"):
        single = Plan(tier=tier, policy="MIX" if tier == "resident" else None)
        out = execute(bp, Plan(tier=tier, batch=4, policy=single.policy))
        for (x, rr), (xs, rrs) in zip(bp.split(out), execute_sequential(
                insts, single)):
            assert torch.equal(x, xs) and torch.equal(rr, rrs), tier
    perks.clear_graphs()


def test_cuda_lane_runner_admission_replays_the_kept_graph(cuda):
    from repro_torch.exec import LaneRunner
    spec = get_spec("2d5pt")
    insts = [StencilProblem(_domain(spec, seed=s), spec, 6, device=cuda)
             for s in range(3)]
    runner = LaneRunner(insts[0], width=2)
    lanes = runner.admit(runner.fresh(), 0, insts[0])
    runner.advance(lanes, 3)
    captured = perks.capture.count
    lanes = runner.admit(lanes, 1, insts[1])
    runner.advance(lanes, 3)
    runner.advance(lanes, 3)
    assert perks.capture.count == captured     # no capture after admit
    assert torch.equal(runner.harvest(lanes, 0),
                       execute(insts[0], Plan(tier="host_loop")))
    assert torch.equal(runner.harvest(lanes, 1),
                       execute(insts[1], Plan(tier="host_loop")))
    perks.clear_graphs()


def test_cuda_service_captures_a_keys_graph_once(cuda):
    from repro_torch.runtime.solver_service import ServiceConfig, SolverService
    spec = get_spec("2d5pt")
    svc = SolverService(ServiceConfig(max_batch=2))
    probs = {svc.submit(StencilProblem(_domain(spec, seed=s), spec, 5,
                                       device=cuda)): s for s in range(6)}
    before = perks.capture.count
    results = svc.drain()
    assert svc.stats()["batches"] == 3
    (chosen,) = svc.chosen_plans().values()
    if chosen.tier == "device_loop":
        assert perks.capture.count - before == 1
    for rid, s in probs.items():
        alone = execute(StencilProblem(_domain(spec, seed=s), spec, 5,
                                       device=cuda), Plan(tier=chosen.tier))
        assert torch.equal(results[rid].result, alone)
    perks.clear_graphs()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_vdot_shared_operand_keeps_each_pairs_bits(dtype, cuda):
    """GMRES's projections: ``vdot(V[:k], w)`` pairs every row of the
    (k, B, n) basis with its lane's vector in one launch, each lane with
    the bits of that pair alone."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((5, 3, 20000))).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((3, 20000))).to(cuda, dtype)
    before = ops.launch_counts()["vdot"]
    got = ops.vdot(a, w)
    assert ops.launch_counts()["vdot"] - before == 1
    assert got.shape == (5, 3)
    for i in range(5):
        for j in range(3):
            assert torch.equal(got[i, j], ops.vdot(a[i, j].clone(),
                                                   w[j].clone()))
    assert torch.equal(ops.vdot(a[:, :1].contiguous(), w[:1]), got[:, :1])


def _krylov_lanes(kind, b, cuda, steps=4, m=8, tol=None):
    from repro_torch.exec import BiCGStabProblem, GMRESProblem
    csr = convdiff2d(48)
    ell = csr.to_ell()
    data = torch.from_numpy(ell.data).to(cuda)     # one operator, shared
    cols = torch.from_numpy(ell.cols).to(cuda)
    rng = np.random.default_rng(11)
    rhs = [rng.standard_normal(ell.data.shape[0]).astype(np.float32)
           for _ in range(b)]
    if kind == "bicgstab":
        first = BiCGStabProblem.from_ell(data, cols, rhs[0], steps,
                                         matrix=csr, tol=tol, device=cuda)
    else:
        first = GMRESProblem.from_ell(data, cols, rhs[0], steps, m=m,
                                      matrix=csr, tol=tol, device=cuda)
    return [first] + [first.with_payload(torch.from_numpy(v).to(cuda))
                      for v in rhs[1:]]


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("kind", ["bicgstab", "gmres"])
def test_cuda_krylov_lanes_are_bit_equal_to_their_instances(kind, b, cuda):
    """BiCGStab and GMRES(m) lanes on the card: every lane bit for bit its
    instance alone on both loop tiers, and a batched step launches
    ``spmv_ell`` and ``vdot`` as often as one instance's step."""
    from repro_torch.exec import BatchedProblem, execute_sequential
    insts = _krylov_lanes(kind, b, cuda)
    bp = BatchedProblem.from_instances(insts)
    for tier in ("host_loop", "device_loop"):
        ops.reset_launch_counts()
        out = execute(bp, Plan(tier=tier, batch=b))
        batched = ops.launch_counts()
        ops.reset_launch_counts()
        seq = execute_sequential(insts, Plan(tier=tier))
        single = ops.launch_counts()
        for i, ((x, rr), (xs, rrs)) in enumerate(zip(bp.split(out), seq)):
            assert torch.equal(x, xs) and torch.equal(rr, rrs), (tier, i)
        if tier == "host_loop":
            for k in ("spmv_ell", "vdot"):
                assert batched[k] * b == single[k], k
    with pytest.raises(NotImplementedError, match="fused"):
        execute(bp, Plan(tier="resident", batch=b))
    perks.clear_graphs()


def test_cuda_async_service_captures_one_chunk_graph_a_key(cuda):
    """The AsyncSolverService on the card: stencil, CG, BiCGStab and GMRES
    keys with admissions mid-solve; each key's chunk graph is captured
    once over the whole run (a later activation of a key replays it), and
    every served result is bit for bit its request alone under the
    engine's cadence."""
    from repro_torch.exec import BiCGStabProblem, GMRESProblem
    from repro_torch.runtime.solver_service import (AsyncConfig,
                                                    AsyncSolverService)
    spec = get_spec("2d5pt")
    ell = poisson2d(32).to_ell()
    data = torch.from_numpy(ell.data).to(cuda)
    cols = torch.from_numpy(ell.cols).to(cuda)
    rng = np.random.default_rng(12)

    def cg():
        return CGProblem.from_ell(data, cols, rng.standard_normal(
            ell.data.shape[0]).astype(np.float32), 200, tol=1e-8,
            device=cuda)

    stencils = [StencilProblem(_domain(spec, seed=s), spec, 12, device=cuda)
                for s in range(5)]
    bicg = _krylov_lanes("bicgstab", 4, cuda, steps=40, tol=1e-8)
    gm = _krylov_lanes("gmres", 3, cuda, steps=4, tol=1e-10)
    eng = AsyncSolverService(AsyncConfig(max_batch=2, chunk_steps=3))
    probs = {}
    for p in stencils[:3] + [cg(), cg()] + bicg[:2] + gm[:2]:
        probs[eng.submit(p)] = p
    results = dict(eng.step())
    for p in (stencils[3], cg(), bicg[2], gm[2]):
        probs[eng.submit(p)] = p
    results.update(eng.run_until_idle())
    for p in (stencils[4], cg(), bicg[3]):   # second activations
        probs[eng.submit(p)] = p
    results.update(eng.run_until_idle())
    assert set(results) == set(probs)
    caps = eng.graph_captures()
    assert len(caps) == 4 and set(caps.values()) == {1}, caps
    assert eng.stats()["admitted_mid_solve"] >= 1
    for rid, p in probs.items():
        chunk = eng.chosen_plans()[p.batch_key()].sync_every
        alone = execute(p, Plan(tier="device_loop", sync_every=chunk))
        got = results[rid].result
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        alone if isinstance(alone, tuple) else (alone,)):
            assert torch.equal(g, w), rid
    assert eng.evict_programs() == 4
    perks.clear_graphs()
