"""The deep schedule's layout (``stencil2d.tb_layout(deep=True)``), which
``csrc/stencil_tb.cu``, its wrapper and the planner share, and its byte
model (``cache_policy.gm_bytes_tb(deep=True)``), on the H100's data-sheet
limits: the units cover every streamed cell once at level t, the rings
hold a stencil's rows, the level-0 window fits the TMA boxes, every depth
the planner offers fits one CTA, and the byte model counts the segments'
warm-up rows. The kernel itself is held to its plain version on the card
(``tests/test_torch_cuda.py``).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cache_policy as tcp
from repro_torch.core import hardware as thw
from repro_torch.exec import StencilProblem, plan_candidates
from repro_torch.kernels import stencil2d
from repro_torch.kernels.common import BENCHMARKS, get_spec

H100 = thw.H100
LIMIT = H100.smem_per_block - stencil2d.PERKS_STATIC_SMEM

LAYOUT_CASES = [  # (shape, radius, t, dtype bytes, cached rows)
    ((1000, 3000), 1, 8, 4, 0), ((1000, 3000), 1, 32, 4, 0),
    ((1000, 3000), 2, 4, 2, 0), ((513, 777), 1, 2, 4, 9),
    ((256, 384), 6, 5, 4, 25), ((45, 37), 1, 8, 4, 0),
    ((64, 64, 64), 1, 8, 4, 0), ((48, 40, 56), 2, 4, 2, 9),
    ((19, 13, 11), 1, 5, 4, 0), ((40, 12, 20), 1, 16, 4, 5),
    # layouts at shallower rings or a narrower strip of a window class
    ((256, 384), 4, 32, 4, 0), ((256, 384), 3, 32, 2, 13),
    ((48, 40, 56), 2, 8, 2, 9),
]


def _layout(shape, r, t, eb, rows):
    lay = stencil2d.tb_layout(shape, r, t, eb, deep=True, ctas=H100.sms,
                              limit=LIMIT, cached_rows=rows)
    assert lay is not None, (shape, r, t, eb, rows)
    return lay


@pytest.mark.parametrize("shape,r,t,eb,rows", LAYOUT_CASES)
def test_deep_units_cover_every_streamed_cell_once(shape, r, t, eb, rows):
    """Strips x segments, as the kernel numbers its units, write each
    streamed cell at level t exactly once, and only streamed cells."""
    lay = _layout(shape, r, t, eb, rows)
    H = shape[0]
    D1, D2 = (shape[1], shape[2]) if len(shape) == 3 else (1, shape[1])
    sy, sx = lay.strip
    count = np.zeros((H, D1, D2), np.int32)
    nseg = -(-(H - rows) // lay.rows)
    for seg, y0, x0 in itertools.product(range(nseg), range(0, D1, sy),
                                         range(0, D2, sx)):
        s0 = rows + seg * lay.rows
        count[s0:min(H, s0 + lay.rows), y0:y0 + sy, x0:x0 + sx] += 1
    assert (count[rows:] == 1).all() and (count[:rows] == 0).all()


@pytest.mark.parametrize("r", range(1, 9))
def test_deep_rings_hold_a_stencil_window(r):
    """Every ring depth the layout may take holds a level's 2r + 1 rows,
    and the levels' rings the row being written too (2r + 2, the least a
    warp holding two adjacent levels needs); the deepest comes first and
    is what a roomy layout takes."""
    rings = stencil2d.deep_rings(r)
    for q0, q in rings:
        assert q0 >= 2 * r + 1 and q >= 2 * r + 2
    assert rings[0][0] == 2 * r + 1 + stencil2d.DEEP_PREFETCH
    assert rings == tuple(sorted(rings, reverse=True))
    lay = _layout((300, 500), r, 2, 4, 0)
    assert lay.rings == rings[0]


@pytest.mark.parametrize("shape,r,t,eb,rows,rings", [
    ((256, 384), 4, 32, 4, 0, 0), ((256, 384), 3, 32, 2, 13, 0),
    ((48, 40, 56), 2, 8, 2, 9, 1),
])
def test_deep_layout_falls_back_before_it_refuses(shape, r, t, eb, rows,
                                                  rings):
    """Shapes whose widest strip of a window class, or whose deepest
    rings, do not fit one CTA take a narrower strip of that class or
    shallower rings instead of refusing the launch."""
    lay = _layout(shape, r, t, eb, rows)
    assert lay.rings == stencil2d.deep_rings(r)[rings]
    assert lay.smem <= LIMIT


@pytest.mark.parametrize("shape,r,t,eb,rows", LAYOUT_CASES)
def test_deep_level_zero_window_fits_the_tma_boxes(shape, r, t, eb, rows):
    """Level 0's columns [x0 - left, x0 - left + width) cover the strip
    widened by r*t and start on a 16-byte column for every strip (TMA
    starts a box nowhere else); they are whole 128-byte boxes in 2D and
    one box of at most 256 x 256 cells in 3D; the scratch is what the
    kernel carves."""
    lay = _layout(shape, r, t, eb, rows)
    sy, sx = lay.strip
    left, width = lay.window
    assert (left, width) == tcp.deep_window(sx, r, t, eb, len(shape))
    assert (sx * eb) % 16 == 0 and (left * eb) % 16 == 0
    assert r * t <= left and left + sx + r * t <= width
    if len(shape) == 2:
        assert sy == 1 and (width * eb) % 128 == 0
    else:
        assert (width * eb) % 16 == 0 and width <= 256
        assert sy + 2 * r * t <= 256
    assert lay.scratch_bytes == stencil2d.deep_scratch_bytes(
        shape, r, t, eb, lay.strip, lay.rings)
    assert lay.smem <= LIMIT


def _meta(shape, name, dtype):
    return StencilProblem(torch.empty(shape, device="meta", dtype=dtype),
                          get_spec(name), 100, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(BENCHMARKS))
def test_every_offered_deep_depth_fits_one_cta(name, dtype):
    spec = get_spec(name)
    shape = (4096, 2048) if spec.ndim == 2 else (160, 160, 128)
    eb = torch.empty((), dtype=dtype).element_size()
    deep = [c for c in plan_candidates(_meta(shape, name, dtype), chip=H100)
            if c.tier == "resident" and c.schedule == "deep"]
    for c in deep:
        lay = _layout(shape, spec.radius, c.fuse_steps, eb, c.cached_rows)
        assert lay.smem <= LIMIT, c
        assert lay.rings in stencil2d.deep_rings(spec.radius)


@pytest.mark.parametrize("shape,r,t,eb,rows", LAYOUT_CASES)
def test_deep_byte_model_counts_the_warm_up_rows(shape, r, t, eb, rows):
    """gm_bytes_tb(deep=True) at the layout is never below gm_bytes_deep,
    and exceeds the one-segment model by exactly the segments' r*ct
    warm-up rows above and below (clamped at the domain), at level 0's
    window, in every pass."""
    lay = _layout(shape, r, t, eb, rows)
    H = shape[0]
    row = int(np.prod(shape[1:])) * eb
    for n in (t, 3 * t + 1, 7):
        kw = dict(radius=r, fuse_steps=t, cached_rows=rows, bands=lay.nb,
                  strip=lay.strip, deep=True)
        got = tcp.gm_bytes_tb(n, shape, eb, rows=lay.rows, **kw)
        one = tcp.gm_bytes_tb(n, shape, eb, rows=H - rows, **kw)
        assert got >= tcp.gm_bytes_deep(n, H * row, rows * row,
                                        fuse_steps=t)
        full, rem = divmod(n, t)
        warm = 0
        for passes, ct in ((full, t), (1, rem)):
            if passes and ct:
                h = r * ct
                segs = range(rows, H, lay.rows)
                extra = sum(s0 - max(0, s0 - h) for s0 in segs) + sum(
                    min(H, s0 + lay.rows + h) - min(H, s0 + lay.rows)
                    for s0 in segs)
                warm += passes * (extra - (rows - max(0, rows - h)))
        # level 0's window a row, clamped to the domain: plane rows of the
        # strips widened by r*t, columns [x0 - left, x0 - left + width)
        D1, D2 = (shape[1], shape[2]) if len(shape) == 3 else (1, shape[1])
        sy, sx = lay.strip
        left, width = lay.window
        hy = r * t if len(shape) == 3 else 0
        ys = sum(min(D1, y0 + sy + hy) - max(0, y0 - hy)
                 for y0 in range(0, D1, sy))
        xs = sum(min(D2, x0 - left + width) - max(0, x0 - left)
                 for x0 in range(0, D2, sx))
        per_row = ys * xs * eb
        assert got - one == warm * per_row, n
