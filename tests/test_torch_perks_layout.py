"""The layout of the one-step PERKS kernel (``csrc/stencil_perks.cu``,
``stencil2d.perks_layout``) on the H100's data-sheet limits, and a numpy
run of its order of reads and writes.

The kernel cuts the cached planes into boxes (bands of planes, and slabs of
plane rows where a plane is wider than a CTA's registers hold), each
updated a block of planes at a time and written back r planes from its
old place, publishing its r-deep faces each step; the streamed rows go through a ring of window rows fed ahead of use,
one contiguous strip of a tile at a time. These tests hold the layout
arithmetic (coverage, fit, alignment) and simulate the kernel's moves with
labelled values: the result is the plain version's bit for bit and no read
finds a value from another step. The kernel itself is held to its plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.common import BENCHMARKS as JAX_SPECS
from repro.kernels.stencil2d import stencil_perks as jax_perks
from repro_torch.core import hardware as thw
from repro_torch.kernels import ops, ref, stencil2d
from repro_torch.kernels.common import BENCHMARKS, get_spec
from repro_torch.kernels.stencil3d import plan_resident_planes

H100 = thw.H100
LIMIT = H100.smem_per_block - stencil2d.PERKS_STATIC_SMEM
NAMES = sorted(BENCHMARKS)


def _planes(shape):
    return (shape[1], shape[2]) if len(shape) == 3 else (1, shape[1])


def _boxes(lay, R, D1):
    """The boxes as the kernel numbers them: (b0, b1, y0, y1) of CTA b <
    nbz * nby."""
    for b in range(lay.boxes):
        bz, by = divmod(b, lay.nby)
        yield (bz * R // lay.nbz, (bz + 1) * R // lay.nbz,
               by * D1 // lay.nby, (by + 1) * D1 // lay.nby)


def _units(shape, lay, R, ctas):
    """Each CTA's streamed units in its walking order, as (s0, s1, ty0,
    ty1, tx0, tx1): unit u is strip u % nseg of tile u // nseg, CTA b walks
    units b, b + ctas, ..."""
    H = shape[0]
    D1, D2 = _planes(shape)
    sy, sx = lay.strip
    nx, ny = -(-D2 // sx), -(-D1 // sy)
    units = lay.nseg * nx * ny if R < H else 0
    out = []
    for b in range(ctas):
        mine = []
        for u in range(b, units, ctas):
            sg, tile = u % lay.nseg, u // lay.nseg
            tyi, txi = divmod(tile, nx)
            mine.append((R + sg * (H - R) // lay.nseg,
                         R + (sg + 1) * (H - R) // lay.nseg,
                         tyi * sy, min(D1, tyi * sy + sy),
                         txi * sx, min(D2, txi * sx + sx)))
        out.append(mine)
    return out


# -- the layout ----------------------------------------------------------------

CASES = [  # (shape, cached planes, or None for the planner's)
    ((8192, 8192), None), ((256, 384), None), ((256, 384), 9),
    ((4096, 2048), None), ((1000, 37), 120), ((256, 256, 256), None),
    ((160, 160, 128), 90), ((48, 40, 56), None), ((48, 40, 56), 5),
    ((64, 130, 200), None), ((30, 9, 11), 6), ((512, 512, 512), None),
]


def _layout(shape, spec, eb, R):
    R = (plan_resident_planes(shape, eb, spec, chip=H100) if R is None
         else R)
    return R, stencil2d.perks_layout(shape, spec.radius, eb, H100.sms, LIMIT,
                                     R)


@pytest.mark.parametrize("eb", [4, 2])
@pytest.mark.parametrize("name", NAMES)
def test_perks_window_and_boxes_fit_one_cta(name, eb):
    """At every Table III spec and both element sizes, the planner's
    cached planes have a layout whose boxes (band and slab cells, halo
    plane rows and the r-plane ring) and window (2r + 1 +
    PERKS_STREAM_ROWS rows of the widened tile, whole 16 bytes) fit one
    CTA beside PERKS_STATIC_SMEM, with every box at least r deep on each
    cut axis and a slab the registers hold."""
    spec = get_spec(name)
    r = spec.radius
    align = 16 // eb
    for shape, rows in CASES:
        if len(shape) != spec.ndim:
            continue
        R, lay = _layout(shape, spec, eb, rows)
        assert lay is not None, (shape, R)
        assert lay.smem <= LIMIT and lay.boxes <= H100.sms
        D1, D2 = _planes(shape)
        if R:
            stored = max(min(D1, y1 + r) - max(0, y0 - r)
                         for _, _, y0, y1 in _boxes(lay, R, D1))
            assert lay.box_bytes == -(-(lay.maxband + r) * stored * D2 * eb
                                      // 16) * 16
            assert lay.maxny * D2 <= stencil2d.PERKS_MAX_ROW_CELLS
            for b0, b1, y0, y1 in _boxes(lay, R, D1):
                assert b1 - b0 >= min(r, R) and b1 - b0 <= lay.maxband
                assert y1 - y0 <= lay.maxny
                if lay.nby > 1:
                    assert y1 - y0 >= r
        if R < shape[0]:
            sy, sx = lay.strip
            left, wx = lay.window
            assert lay.slots == 2 * r + 1 + stencil2d.PERKS_STREAM_ROWS
            assert lay.window_bytes == lay.slots * (
                lay.wy * wx * eb + stencil2d.PERKS_OFFSET_BYTES)
            assert lay.window_bytes <= (stencil2d.PERKS_WINDOW_BYTES_3D
                                        if len(shape) == 3 else
                                        stencil2d.PERKS_WINDOW_BYTES)
            assert sx % align == 0 and left % align == 0 and wx % align == 0
            assert left >= r and lay.wy == (min(D1, sy + 2 * r)
                                            if len(shape) == 3 else 1)
            assert wx >= min(-(-D2 // align) * align, left + sx + r)
            assert sy * min(sx, D2) <= (stencil2d.ONE_THREADS
                                        * stencil2d.ONE_TILE_CELLS)
            assert 1 <= lay.nseg <= shape[0] - R
        else:
            assert lay.window_bytes == 0


def test_perks_main_cells_keep_a_band_and_cache_3d_planes():
    """2d5pt 8192^2 f32: the window (8 rows of 920 columns) costs one band
    row, 5 rows a CTA against the 6 the kernel held without it; bf16 11
    rows a CTA beside 1368-column tiles. 3d7pt 256^3: 256^2 planes are
    wider than a CTA's registers, so the planes are cut into 12 slabs of
    21-22 plane rows and a part of the domain is cached."""
    spec = get_spec("2d5pt")
    R, lay = _layout((8192, 8192), spec, 4, None)
    assert R == 132 * 5 and lay.maxband == 5 and lay.nby == 1
    assert stencil2d.rows_per_cta(8192, 4, 1, LIMIT) == 6
    assert stencil2d.rows_per_cta(8192, 4, 1, LIMIT, lay.window_bytes) == 5
    assert lay.strip == (1, 912) and lay.window == (4, 920)
    assert stencil2d.band_smem_bytes(R, 1, 8192 * 4, H100.sms,
                                     lay.window_bytes) == lay.smem
    R2, lay2 = _layout((8192, 8192), spec, 2, None)
    assert R2 == 132 * 11 and lay2.strip == (1, 1368)
    R3, lay3 = _layout((256, 256, 256), get_spec("3d7pt"), 4, None)
    assert 0 < R3 < 256 and lay3.nby > 1 and lay3.boxes <= H100.sms
    assert R3 == plan_resident_planes((256, 256, 256), 4, get_spec("3d27pt"),
                                      chip=H100)


@pytest.mark.parametrize("shape,rows", CASES)
def test_perks_strips_cover_every_streamed_row_once(shape, rows):
    """The units, as the CTAs walk them, hold every streamed cell once and
    no cached one; with strips a multiple of the tiles' share of the grid,
    every CTA walks one contiguous strip."""
    spec = get_spec("2d5pt" if len(shape) == 2 else "3d7pt")
    R, lay = _layout(shape, spec, 4, rows)
    if R >= shape[0]:
        return
    D1, D2 = _planes(shape)
    H = shape[0]
    walks = _units(shape, lay, R, H100.sms)
    if H * D1 * D2 > 4_000_000:       # count on a window of the domain
        H = min(H, R + 3 * -(-(shape[0] - R) // lay.nseg))
    count = np.zeros((H, D1, D2), np.int32)
    for mine in walks:
        for s0, s1, y0, y1, x0, x1 in mine:
            assert s1 > s0
            count[s0:min(s1, H), y0:y1, x0:x1] += 1
    assert (count[R:] == 1).all() and (count[:R] == 0).all()
    sy, sx = lay.strip
    tiles = -(-D1 // sy) * -(-D2 // sx)
    if lay.nseg * tiles > H100.sms and H100.sms % lay.nseg == 0:
        for mine in walks:
            assert len({(s0, s1) for s0, s1, *_ in mine}) == 1


@pytest.mark.parametrize("shape,rows", [c for c in CASES if c[1] is not None]
                         + [((256, 256, 256), None), ((512, 512, 512), None),
                            ((64, 130, 200), None)])
def test_perks_boxes_cover_the_cached_cells_once(shape, rows):
    """The boxes hold every cached cell once, each at least r planes deep
    and, cut in plane rows, at least r plane rows deep."""
    for name in ("2d5pt", "2ds25pt") if len(shape) == 2 else ("3d7pt",
                                                              "3d13pt"):
        spec = get_spec(name)
        r = spec.radius
        R, lay = _layout(shape, spec, 4, rows)
        if lay is None:
            continue
        D1, D2 = _planes(shape)
        count = np.zeros((R, D1), np.int32)
        for b0, b1, y0, y1 in _boxes(lay, R, D1):
            assert b1 - b0 >= r and (lay.nby == 1 or y1 - y0 >= r)
            count[b0:b1, y0:y1] += 1
        assert (count == 1).all(), (shape, name)


def test_perks_cached_rows_is_the_most_the_layout_holds():
    """perks_cached_rows is a layout the kernel takes, and one more plane
    (where a plane still streams) is not."""
    for shape, name in (((8192, 8192), "2d5pt"), ((256, 256, 256), "3d7pt"),
                        ((512, 512, 512), "3d27pt"), ((4096, 1024), "2ds25pt"),
                        ((300, 160, 160), "3d13pt")):
        r = get_spec(name).radius
        for eb in (4, 2):
            cap = stencil2d.perks_cached_rows(shape, r, eb, H100.sms, LIMIT)
            assert cap > 0
            assert stencil2d.perks_layout(shape, r, eb, H100.sms, LIMIT,
                                          cap) is not None
            if cap + 1 < shape[0]:
                assert stencil2d.perks_layout(shape, r, eb, H100.sms, LIMIT,
                                              cap + 1) is None


# -- a numpy run of the kernel's moves ----------------------------------------

def _simulate(x, spec, steps, lay, R, ctas, kb=None, slots=None):
    """The kernel's reads and writes on float32 numpy arrays, each value
    labelled with its cell and step: boxes moving r planes a step (shared
    memory),
    faces and streamed rows into the step's output buffer, window rows fed
    PERKS_STREAM_ROWS ahead into a ring of ``slots`` rows. The CTAs of a
    step run one after another (a CTA reads only src and its own shared
    memory, and writes only dst). Returns (result, reads that found the
    wrong label)."""
    X = x if x.ndim == 3 else x[:, None, :]
    H, D1, D2 = X.shape
    r = spec.radius
    A = stencil2d.PERKS_STREAM_ROWS
    Q = lay.slots if slots is None else slots
    offs = [(o[0], o[1], o[2]) if x.ndim == 3 else (o[0], 0, o[1])
            for o in spec.offsets]
    w = [np.float32(v) for v in spec.weights]
    stride = steps + 1
    cid = np.arange(H * D1 * D2).reshape(H, D1, D2) * stride
    bufs = [[np.zeros_like(X), np.full(X.shape, -1)] for _ in range(2)]
    bad = []

    def interior(j, ys, xs):
        return ((r <= j < H - r)
                & ((ys >= r) & (ys < D1 - r) if x.ndim == 3 else True)
                & (xs >= r) & (xs < D2 - r))

    def stencil_sum(read, j, ys, xs, k, inside):
        """The spec-ordered sum at cells (j, ys, xs) with read(j', ys', xs')
        -> (values, labels); labels checked where ``inside``."""
        acc = None
        for (d0, d1, d2), wk in zip(offs, w):
            v, lab = read(j + d0, ys + d1, xs + d2)
            want = cid[j + d0, np.clip(ys + d1, 0, D1 - 1),
                       np.clip(xs + d2, 0, D2 - 1)] + k
            if (lab != want)[inside].any():
                bad.append(("sum", k, j, d0, d1, d2))
            t = (v * wk).astype(np.float32)
            acc = t if acc is None else (acc + t).astype(np.float32)
        return acc

    # a box: its planes (box-relative jj) at storage plane jj + off, the
    # storage r planes deeper than the box
    boxes = {}
    for b, (b0, b1, y0, y1) in enumerate(_boxes(lay, R, D1) if R else []):
        ylo, yhi = max(0, y0 - r), min(D1, y1 + r)
        bv = np.zeros((b1 - b0 + r, yhi - ylo, D2), np.float32)
        bl = np.full(bv.shape, -1)
        bv[:b1 - b0] = X[b0:b1, ylo:yhi]
        bl[:b1 - b0] = cid[b0:b1, ylo:yhi]
        boxes[b] = [bv, bl, 0]
    walks = _units(X.shape if x.ndim == 3 else x.shape, lay, R, ctas)

    for k in range(steps):
        src = [X, cid] if k == 0 else bufs[(k - 1) & 1]
        dst = bufs[k & 1]
        for b, (b0, b1, y0, y1) in enumerate(_boxes(lay, R, D1) if R else []):
            bv, bl, off = boxes[b]
            n = b1 - b0
            ylo, yhi = max(0, y0 - r), min(D1, y1 + r)
            u0, u1 = y0 - ylo, y1 - ylo
            # the halo plane rows, from the neighbours' faces in src, at the
            # planes' present place
            for a0, a1 in ((ylo, y0), (y1, yhi)):
                bv[off:off + n, a0 - ylo:a1 - ylo] = src[0][b0:b1, a0:a1]
                bl[off:off + n, a0 - ylo:a1 - ylo] = src[1][b0:b1, a0:a1]
            step_kb = kb or max(1, min(
                stencil2d.ONE_THREADS * stencil2d.ONE_CELLS
                // ((y1 - y0) * D2), 32))
            no = r if off == 0 else 0
            blocks = [(j0, min(n, j0 + step_kb)) for j0 in range(0, n, step_kb)]
            if no > off:
                blocks.reverse()

            def read(j, ys, xs):
                yc = np.clip(ys - ylo, 0, yhi - ylo - 1)
                xc = np.clip(xs, 0, D2 - 1)
                if b0 <= j < b1:
                    return bv[j - b0 + off][yc, xc], bl[j - b0 + off][yc, xc]
                yg = np.clip(ys, 0, D1 - 1)
                return src[0][j][yg, xc], src[1][j][yg, xc]

            ys = np.arange(y0, y1)[:, None]
            xs = np.arange(D2)[None, :]
            for j0, j1 in blocks:
                new = []
                for j in range(b0 + j0, b0 + j1):
                    own_v, own_l = read(j, ys, xs)
                    inside = np.broadcast_to(interior(j, ys, xs), own_v.shape)
                    if (own_l != cid[j, y0:y1] + k).any():
                        bad.append(("own", k, j))
                    v = own_v.copy()
                    if inside.any():
                        s = stencil_sum(read, j, ys, xs, k, inside)
                        v[inside] = s[inside]
                    new.append(v)
                for jj, v in zip(range(j0, j1), new):   # after the barrier
                    bv[jj + no][u0:u1] = v
                    bl[jj + no][u0:u1] = cid[b0 + jj, y0:y1] + k + 1
            boxes[b][2] = off = no
            faces = set(range(min(r, n))) | set(range(max(n - r, 0), n))
            for jj in range(n):
                rows_ = range(y0, y1) if jj in faces else (
                    [y for y in range(y0, y1) if lay.nby > 1 and (
                        (y0 > 0 and y < y0 + r) or (y1 < D1 and y >= y1 - r))])
                for y in rows_:
                    dst[0][b0 + jj, y] = bv[jj + off][y - ylo]
                    dst[1][b0 + jj, y] = bl[jj + off][y - ylo]
        # the streamed rows, through the window ring
        left, wx = lay.window
        for mine in walks:
            if not mine:
                continue
            loads = [(u, m) for u, un in enumerate(mine)
                     for m in range(un[1] - un[0] + 2 * r)]
            win_v = np.zeros((Q, max(lay.wy, 1), max(wx, 1)), np.float32)
            win_l = np.full(win_v.shape, -1)

            def origin(un):
                return (max(0, un[2] - r) if x.ndim == 3 else 0,
                        max(0, un[4] - left))

            def issue(L):
                if L >= len(loads):
                    return
                u, m = loads[L]
                un = mine[u]
                j = un[0] - r + m
                if not 0 <= j < H:
                    return
                oy, ox = origin(un)
                yb = min(D1, un[3] + r) if x.ndim == 3 else 1
                xb = min(D2, -(-min(D2, un[5] + r) // 4) * 4)
                win_v[L % Q, :yb - oy, :xb - ox] = src[0][j, oy:yb, ox:xb]
                win_l[L % Q, :yb - oy, :xb - ox] = src[1][j, oy:yb, ox:xb]

            for L in range(A):
                issue(L)
            for L, (u, m) in enumerate(loads):
                issue(L + A)
                if m < 2 * r:
                    continue
                un = mine[u]
                j = un[0] + m - 2 * r
                oy, ox = origin(un)
                ys = np.arange(un[2], un[3])[:, None]
                xs = np.arange(un[4], un[5])[None, :]

                def read(jj, ys_, xs_, L=L, j=j, oy=oy, ox=ox):
                    sl = (L - r + (jj - j)) % Q
                    yc = np.clip(ys_ - oy, 0, win_v.shape[1] - 1)
                    xc = np.clip(xs_ - ox, 0, win_v.shape[2] - 1)
                    return win_v[sl][yc, xc], win_l[sl][yc, xc]

                own_v, own_l = read(j, ys, xs)
                if (own_l != cid[j, un[2]:un[3], un[4]:un[5]] + k).any():
                    bad.append(("own-stream", k, j))
                inside = np.broadcast_to(interior(j, ys, xs), own_v.shape)
                v = own_v.copy()
                if inside.any():
                    s = stencil_sum(read, j, ys, xs, k, inside)
                    v[inside] = s[inside]
                dst[0][j, un[2]:un[3], un[4]:un[5]] = v
                dst[1][j, un[2]:un[3], un[4]:un[5]] = \
                    cid[j, un[2]:un[3], un[4]:un[5]] + k + 1
    fin = bufs[(steps - 1) & 1]
    for b, (b0, b1, y0, y1) in enumerate(_boxes(lay, R, D1) if R else []):
        ylo = max(0, y0 - r)
        bv, bl, off = boxes[b]
        fin[0][b0:b1, y0:y1] = bv[off:off + b1 - b0, y0 - ylo:y1 - ylo]
        fin[1][b0:b1, y0:y1] = bl[off:off + b1 - b0, y0 - ylo:y1 - ylo]
    if (fin[1] != cid + steps).any():
        bad.append(("final labels",))
    out = fin[0] if x.ndim == 3 else fin[0][:, 0, :]
    return out, bad


def _small_layout(shape, spec, R, ctas, budget=None, nby=None):
    """The kernel's layout over ``ctas`` CTAs; ``budget`` bytes of box
    shared memory (forcing slabs), or ``nby`` slabs given outright."""
    r = spec.radius
    limit = LIMIT if budget is None else budget
    win = stencil2d.perks_window(shape, r, 4)
    lay = stencil2d.perks_layout(shape, r, 4, ctas, limit + (
        win[4] if budget is not None and R < shape[0] else 0), R)
    assert lay is not None
    if nby is not None:
        D1 = shape[1]
        nbz, maxband = stencil2d.band_layout(R, r, ctas // nby)
        lay = dataclasses.replace(lay, nbz=nbz, nby=nby, maxband=maxband,
                                  maxny=-(-D1 // nby))
    return lay


SIM_CASES = [  # (spec, shape, cached planes, CTAs, slabs, block planes)
    ("2d5pt", (40, 37), 13, 4, None, None),
    ("2d5pt", (40, 37), 13, 4, None, 2),
    ("2ds9pt", (30, 24), 9, 3, None, 1),
    ("2d9pt", (33, 64), 0, 5, None, None),
    ("2ds25pt", (60, 40), 25, 2, None, 4),
    ("2d13pt", (35, 30), 35, 6, None, 3),
    ("3d7pt", (14, 20, 9), 6, 9, 3, 2),
    ("3d7pt", (14, 20, 9), 6, 9, 3, None),
    ("3d27pt", (16, 17, 12), 7, 6, 2, 1),
    ("3d13pt", (20, 16, 10), 8, 8, 4, 3),
    ("poisson", (12, 15, 11), 12, 10, 5, 2),
    ("3d17pt", (11, 9, 14), 4, 2, None, None),
]


@pytest.mark.parametrize("name,shape,R,ctas,nby,kb", SIM_CASES)
def test_perks_kernel_moves_give_the_plain_result(name, shape, R, ctas, nby,
                                                  kb):
    """The box update (blocks of planes written back r planes shifted,
    bottom-up and top-down in turn), the published faces, the halo plane
    rows and the streamed strips' window ring, in the kernel's order:
    bit-equal to ``ref.stencil_run``, and no read finds a value already
    overwritten or not yet written."""
    spec = get_spec(name)
    x = np.random.default_rng(len(shape) + R).standard_normal(shape).astype(
        np.float32)
    lay = _small_layout(shape, spec, R, ctas, nby=nby)
    for steps in (1, 4):
        got, bad = _simulate(x, spec, steps, lay, R, ctas, kb=kb)
        assert bad == []
        want = ref.stencil_run(torch.from_numpy(x), spec, steps).numpy()
        assert np.array_equal(got, want), (steps, lay)


def test_perks_window_one_slot_short_would_overwrite():
    """The simulation sees the hazard the window's size avoids: with one
    slot fewer than 2r + 1 + PERKS_STREAM_ROWS a row fed ahead overwrites
    a row still in use."""
    spec = get_spec("2d5pt")
    shape = (40, 37)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    lay = _small_layout(shape, spec, 5, 2)
    _, bad = _simulate(x, spec, 2, lay, 5, 2, slots=lay.slots - 1)
    assert bad


def test_perks_box_blocks_written_in_place_would_overwrite():
    """The simulation's hazard, which the r-plane shift avoids: blocks of
    planes written back in place, one after the other, feed a later block
    a plane already updated."""
    spec = get_spec("2d5pt")
    n, kb = 10, 3
    S = {j: (j, 0) for j in range(n)}
    bad = []
    for i in range(0, n, kb):
        i1 = min(n, i + kb)
        bad += [jj for j in range(i, i1) for jj in (j - 1, j + 1)
                if 0 <= jj < n and S[jj] != (jj, 0)]
        for j in range(i, i1):
            S[j] = (j, 1)
    assert bad and spec.radius == 1


def test_perks_wide_planes_match_the_reference():
    """A 3D domain whose 12 x 20 planes are wider than this test's register
    limit (ONE_THREADS * ONE_CELLS cut to 60 cells): the layout cuts the
    cached planes into slabs, the simulated kernel gives the JAX package's
    stencil_perks output (interpret mode) at its kernel bound, and the
    port's stencil_perks on the CPU does too."""
    spec = get_spec("3d7pt")
    shape, R, steps = (16, 12, 20), 7, 5
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_perks(jnp.asarray(x), JAX_SPECS["3d7pt"],
                                steps=steps, cached_rows=R, sub_rows=8))
    mp = pytest.MonkeyPatch()
    mp.setattr(stencil2d, "PERKS_MAX_ROW_CELLS", 60)
    try:
        win = stencil2d.perks_window(shape, spec.radius, 4)[4]
        lay = stencil2d.perks_layout(shape, spec.radius, 4, 8, win + 2048, R)
    finally:
        mp.undo()
    assert lay is not None and lay.nby > 1 and lay.maxny * shape[2] <= 60
    got, bad = _simulate(x, spec, steps, lay, R, 8)
    assert bad == []
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
    port = ops.stencil_perks(torch.from_numpy(x), spec=spec, steps=steps,
                             cached_rows=R, sub_rows=8)
    np.testing.assert_allclose(port.numpy(), want, rtol=0, atol=5e-6)


def test_perks_step_cost_counts_boxes_and_strips():
    """perks_step_cost grows with the streamed rows and the stencil's
    reach (more halo rows a strip), and is the boxes' alone where every
    plane is cached."""
    shape = (8192, 8192)
    costs = []
    for R in (0, 330, 660):
        lay = stencil2d.perks_layout(shape, 1, 4, H100.sms, LIMIT, R)
        costs.append(stencil2d.perks_step_cost(shape, 1, lay, R, H100.sms))
    assert costs[0] > costs[1] > costs[2] > 0
    full = (160, 160, 128)
    lay = stencil2d.perks_layout(full, 1, 4, H100.sms, LIMIT, 160)
    assert lay.window_bytes == 0
    assert stencil2d.perks_step_cost(full, 1, lay, 160, H100.sms) == (
        lay.maxband * min(160, lay.maxny + 2) * 128 / stencil2d.ONE_THREADS)


def _kernel_bytes(shape, r, eb, lay, R, steps):
    """Device-memory bytes the one-step kernel moves, counted as it moves
    them: each box loaded with its halo plane rows and stored once, its halo
    plane rows read and its faces written each step; each unit's window
    rows (the rows within r of its strip, clamped; the plane rows within r
    of its tile, clamped; the columns from max(0, x0 - left) to x1 + r,
    rounded up to 16 bytes and clamped) read and its rows written, every
    step."""
    H = shape[0]
    D1, D2 = _planes(shape)
    align = 16 // eb
    once = per = 0
    for b0, b1, y0, y1 in _boxes(lay, R, D1) if R else []:
        n = b1 - b0
        stored = min(D1, y1 + r) - max(0, y0 - r) if lay.nby > 1 else D1
        once += n * (stored + (y1 - y0)) * D2
        per += n * (stored - (y1 - y0)) * D2
        faces = set(range(min(r, n))) | set(range(max(n - r, 0), n))
        for jj in range(n):
            if jj in faces:
                per += (y1 - y0) * D2
            elif lay.nby > 1:
                cut = (r if y0 > 0 else 0) + (r if y1 < D1 else 0)
                per += min(cut, y1 - y0) * D2
    left = lay.window[0]
    for mine in _units(shape, lay, R, H100.sms):
        for s0, s1, ty0, ty1, tx0, tx1 in mine:
            rows = min(H, s1 + r) - max(0, s0 - r)
            ya = max(0, ty0 - r) if len(shape) == 3 else 0
            yb = min(D1, ty1 + r) if len(shape) == 3 else 1
            xa = max(0, tx0 - left)
            xb = min(D2, -(-min(D2, tx1 + r) // align) * align)
            per += rows * (yb - ya) * (xb - xa) + (s1 - s0) * (ty1 - ty0) * (
                tx1 - tx0)
    return (once + steps * per) * eb


@pytest.mark.parametrize("shape,name,eb", [
    ((8192, 8192), "2d5pt", 4), ((8192, 8192), "2d5pt", 2),
    ((256, 256, 256), "3d7pt", 4), ((256, 256, 256), "3d27pt", 2),
    ((1000, 37), "2ds25pt", 4), ((64, 130, 200), "3d13pt", 4)])
def test_perks_byte_model_holds_what_the_kernel_moves(shape, name, eb):
    """cache_policy.gm_bytes_perks (the planner's bytes of a one-step
    plan) is at least what the kernel moves and within 2% of it; both are
    at least Eq. 5 at the plan's cached planes."""
    from repro_torch.core import cache_policy as tcp
    spec = get_spec(name)
    r = spec.radius
    R, lay = _layout(shape, spec, eb, None)
    if R >= shape[0]:
        R = shape[0] // 2
        lay = stencil2d.perks_layout(shape, r, eb, H100.sms, LIMIT, R)
    model = tcp.gm_bytes_perks(100, shape, eb, radius=r, cached_rows=R,
                               boxes=(lay.nbz, lay.nby), strip=lay.strip,
                               left=lay.window[0], strips=lay.nseg)
    moved = _kernel_bytes(shape, r, eb, lay, R, 100)
    row = int(np.prod(shape[1:])) * eb
    eq5 = 2 * 100 * (shape[0] - R) * row + 2 * R * row
    assert moved >= eq5
    assert moved <= model <= 1.02 * moved, (model / moved)
