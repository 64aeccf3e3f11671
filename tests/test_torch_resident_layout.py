"""The layouts of the redesigned stencil kernels, on the H100's data-sheet
limits: ``stencil2d.resident_layout`` (``csrc/stencil_resident.cu``, every
row cached) and the shallow tiles of ``stencil2d.tb_layout(deep=False)``
(``csrc/stencil_shallow.cu``). The kernels walk these layouts with the same
arithmetic as the simulations below: the resident blocks and their row
shift never overwrite a row a later block reads, every cell of a band is
one thread's for one step, the tiles cover every streamed cell once, the
windows hold the r*t halos from 16-byte columns, everything fits one CTA,
and the resident capacity is the one-step kernel's. The kernels themselves
are held to their plain version on the card (``tests/test_torch_cuda.py``).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hardware as thw
from repro_torch.kernels import stencil2d
from repro_torch.kernels.common import BENCHMARKS, get_spec
from repro_torch.kernels.stencil3d import plan_resident_planes

H100 = thw.H100
LIMIT = H100.smem_per_block - stencil2d.PERKS_STATIC_SMEM
NAMES = sorted(BENCHMARKS)


def _planes(shape):
    return (shape[1], shape[2]) if len(shape) == 3 else (1, shape[1])


# -- stencil_resident ---------------------------------------------------------

def _parent_holds(shape, r, eb):
    """Whether the one-step kernel's capacity (rows_per_cta,
    band_smem_bytes) holds the whole domain: the parent's stencil_resident
    ran exactly those."""
    P = int(np.prod(shape[1:]))
    if P > stencil2d.PERKS_MAX_ROW_CELLS:
        return False
    return stencil2d.band_smem_bytes(shape[0], r, P * eb, H100.sms) <= LIMIT


@pytest.mark.parametrize("eb", [4, 2])
@pytest.mark.parametrize("name", NAMES)
def test_resident_capacity_is_the_one_step_kernels(name, eb):
    """At every row width, around the most rows the one-step kernel's
    layout held, the new kernel holds exactly the domains it held (and
    every one plan_resident_planes offers whole)."""
    spec = get_spec(name)
    r = spec.radius
    widths = ([37, 384, 1152, 4096, 8192, 20480] if spec.ndim == 2
              else [(9, 11), (40, 56), (64, 64), (128, 160)])
    for w in widths:
        plane = (w,) if spec.ndim == 2 else w
        P = int(np.prod(plane))
        cap = H100.sms * stencil2d.rows_per_cta(P, eb, r, LIMIT)
        if cap < r:
            continue
        for H in (cap - 1, cap, cap + 1):
            shape = (H,) + plane
            lay = stencil2d.resident_layout(shape, r, eb, H100.sms, LIMIT)
            assert (lay is not None) == _parent_holds(shape, r, eb), shape
        full = (cap,) + plane
        if plan_resident_planes(full, eb, spec, chip=H100) == cap:
            assert stencil2d.resident_layout(full, r, eb, H100.sms,
                                             LIMIT) is not None


RESIDENT_CASES = [  # (shape, radius, dtype bytes)
    ((3072, 1152), 1, 4), ((256, 384), 1, 4), ((100, 37), 2, 2),
    ((1320, 4000), 1, 4), ((2640, 4000), 2, 2), ((6468, 1152), 1, 4),
    ((48, 40, 56), 1, 4), ((30, 9, 11), 2, 2), ((528, 8, 1025), 3, 4),
    ((2376, 1821), 8, 4),
]


@pytest.mark.parametrize("shape,r,eb", RESIDENT_CASES)
def test_resident_layout_fits_one_cta(shape, r, eb):
    """The registers hold a block (at most RES_CELLS values a thread), the
    blocks cover the band, and the band with its r-row shift and halo rows
    (3r rows), or its shift alone, fits the CTA's shared memory."""
    lay = stencil2d.resident_layout(shape, r, eb, H100.sms, LIMIT)
    assert lay is not None
    P = int(np.prod(shape[1:]))
    assert lay.cells == -(-lay.kb * P // stencil2d.RES_THREADS)
    assert lay.cells <= stencil2d.RES_CELLS
    assert lay.blocks * lay.kb >= lay.maxband > (lay.blocks - 1) * lay.kb
    assert lay.smem <= LIMIT
    extra = 3 * r if lay.halo else r
    assert lay.smem == (lay.maxband + extra) * P * eb
    D1, D2 = _planes(shape)
    reach = r * P + (r * D2 if len(shape) == 3 else 0) + r
    assert lay.halo == ((lay.maxband + 3 * r) * P * eb <= LIMIT
                        and 2 * reach < (lay.maxband + 3 * r) * P)
    assert stencil2d.RES_THREADS * stencil2d.RES_CELLS >= \
        stencil2d.PERKS_MAX_ROW_CELLS


def test_resident_main_cell_keeps_its_halo_rows_on_chip():
    """stencil small (2d5pt 3072x1152): 24-row bands in two blocks of 12
    rows (27 values a thread), halo rows in shared memory."""
    lay = stencil2d.resident_layout((3072, 1152), 1, 4, H100.sms, LIMIT)
    assert lay.halo and lay.blocks == 2 and lay.kb == 12
    assert lay.maxband == 24 and lay.cells == 27


def _thread_cells(tid, shape, j0, j1):
    """The cells (row, plane row, column) of block [j0, j1) that thread tid
    holds, slot by slot: the flat index steps by RES_THREADS and the
    in-row position is carried along, as the kernel does it."""
    D1, D2 = _planes(shape)
    P, NT = D1 * D2, stencil2d.RES_THREADS
    ys, xs = divmod(NT % P, D2)
    y, x = divmod(tid % P, D2)
    idx = j0 * P + tid
    out = []
    for _ in range(stencil2d.RES_CELLS):
        if idx < j1 * P:
            j, c = divmod(idx, P)
            assert (y, x) == divmod(c, D2)
            out.append((j, y, x))
        idx += NT
        x += xs
        y += ys
        if x >= D2:
            x, y = x - D2, y + 1
        if y >= D1:
            y -= D1
    return out


@pytest.mark.parametrize("shape,r,eb", RESIDENT_CASES[:8])
def test_resident_threads_hold_every_band_cell_once(shape, r, eb):
    """Every cell of each block of the largest band is one thread's, in
    one register slot, and no thread runs out of slots."""
    lay = stencil2d.resident_layout(shape, r, eb, H100.sms, LIMIT)
    D1, D2 = _planes(shape)
    n = lay.maxband
    count = np.zeros((n, D1, D2), np.int32)
    for j0 in range(0, n, lay.kb):
        j1 = min(n, j0 + lay.kb)
        held = 0
        for tid in range(stencil2d.RES_THREADS):
            cells = _thread_cells(tid, shape, j0, j1)
            held += len(cells)
            for j, y, x in cells:
                count[j, y, x] += 1
        assert held == (j1 - j0) * D1 * D2
    assert (count == 1).all()


def _simulate_band(n, r, kb, steps, halo):
    """The kernel's shared-memory moves for one band of n rows, as
    (row, step) labels: blocks of kb rows read rows j - r .. j + r (inside
    the band, and with halo rows also the r rows beside it, from shared
    memory; else from device memory) and, after the block's barrier, write
    their new rows r rows below (from the first place, bottom-up) or above
    (from the second, top-down); with halo rows the neighbours' borders
    are copied beside the band's new place after the grid barrier. Returns
    the reads that found the wrong label."""
    base = r if halo else 0
    S = [None] * (n + (3 * r if halo else r))
    off = base
    lo, hi = (-r, n + r) if halo else (0, n)
    for j in range(lo, hi):
        S[j + off] = (j, 0)
    bad = []
    nblk = -(-n // kb)
    for k in range(steps):
        no = base + r if off == base else base
        order = range(nblk) if no < off else reversed(range(nblk))
        for b in order:
            j0, j1 = b * kb, min(n, (b + 1) * kb)
            for j in range(j0, j1):
                for jj in range(j - r, j + r + 1):
                    if lo <= jj < hi and S[jj + off] != (jj, k):
                        bad.append((k, j, jj, S[jj + off]))
            for j in range(j0, j1):   # after the block's barrier
                S[j + no] = (j, k + 1)
        off = no
        if halo:                      # after grid.sync()
            for j in list(range(-r, 0)) + list(range(n, n + r)):
                S[j + off] = (j, k + 1)
    return bad


@pytest.mark.parametrize("n,r,kb", [(24, 1, 24), (24, 1, 15), (10, 1, 4),
                                    (10, 4, 3), (49, 1, 28), (18, 8, 5),
                                    (7, 3, 1), (899, 1, 512)])
@pytest.mark.parametrize("steps", [1, 2, 5, 8])
def test_resident_row_shift_never_reads_an_overwritten_row(n, r, kb, steps):
    """Blocks written r rows from their old place, bottom-up then
    top-down, with and without halo rows beside the band, read the
    previous step's value of every row, odd and even steps."""
    assert _simulate_band(n, r, kb, steps, halo=False) == []
    assert _simulate_band(n, r, kb, steps, halo=True) == []


def test_resident_in_place_blocks_would_overwrite():
    """The simulation sees the hazard the shift avoids: blocks written in
    place, one after the other, feed a later block a new row."""
    n, r, kb = 10, 1, 4
    S = {j: (j, 0) for j in range(n)}
    bad = []
    for b in range(-(-n // kb)):
        j0, j1 = b * kb, min(n, (b + 1) * kb)
        bad += [jj for j in range(j0, j1) for jj in (j - 1, j + 1)
                if 0 <= jj < n and S[jj] != (jj, 0)]
        for j in range(j0, j1):
            S[j] = (j, 1)
    assert bad


# -- the shallow tiles ----------------------------------------------------------

SHALLOW_CASES = list(itertools.product(
    [((1000, 3000), 0), ((513, 777), 9), ((45, 37), 0), ((8192, 8192), 0),
     ((64, 64, 64), 0), ((48, 40, 56), 9), ((19, 13, 11), 0),
     ((256, 256, 256), 0)],
    range(1, 9), (2, 3, 4), (4, 2)))


def _shallow(shape, r, t, eb, rows):
    """The shallow layout, or None after checking that the parent's layout
    refused it too: its bands beside two buffers of the least tile (one
    cell, one row, widened by r*t and clamped to the domain)."""
    lay = stencil2d.tb_layout(shape, r, t, eb, deep=False, ctas=H100.sms,
                              limit=LIMIT, cached_rows=rows)
    if lay is None:
        D1, D2 = _planes(shape)
        w = 1 + 2 * r * t
        nb, maxband = stencil2d.band_layout(rows, r, H100.sms)
        band = 0 if nb == 0 else -(-(maxband + 2 * r * t + r)
                                   * D1 * D2 * eb // 16) * 16
        least = 2 * min(shape[0], w) * (min(D1, w) if len(shape) == 3
                                        else 1) * min(D2, w) * eb
        assert band + least > LIMIT, (shape, r, t, eb, rows)
    return lay


def _tiles(shape, lay, rows):
    """The tiles as the kernel numbers them (tile_at): (s0, s1, y0, y1,
    x0, x1)."""
    H = shape[0]
    D1, D2 = _planes(shape)
    sy, sx = lay.strip
    nx, ny = -(-D2 // sx), -(-D1 // sy)
    ntiles = -(-(H - rows) // lay.rows) * nx * ny
    for tile in range(ntiles):
        txi, rest = tile % nx, tile // nx
        tyi, ti = rest % ny, rest // ny
        s0 = rows + ti * lay.rows
        yield (s0, min(H, s0 + lay.rows), tyi * sy, min(D1, tyi * sy + sy),
               txi * sx, min(D2, txi * sx + sx))


@pytest.mark.parametrize("case", SHALLOW_CASES[::7] + SHALLOW_CASES[3::11])
def test_shallow_tiles_cover_every_streamed_cell_once(case):
    """The tiles, as the kernel numbers them, write each streamed cell at
    level t once, and only streamed cells; a layout is refused only where
    the parent's refused it too (``_shallow``)."""
    (shape, rows), r, t, eb = case
    lay = _shallow(shape, r, t, eb, rows)
    if lay is None:
        return
    D1, D2 = _planes(shape)
    if shape[0] * D1 * D2 > 4_000_000:   # count on a window of the domain
        shape = (min(shape[0], rows + 3 * lay.rows),) + shape[1:]
        D1, D2 = _planes(shape)
    count = np.zeros((shape[0], D1, D2), np.int32)
    for s0, s1, y0, y1, x0, x1 in _tiles(shape, lay, rows):
        count[s0:s1, y0:y1, x0:x1] += 1
    assert (count[rows:] == 1).all() and (count[:rows] == 0).all()


@pytest.mark.parametrize("case", SHALLOW_CASES[::5])
def test_shallow_windows_hold_the_halo_and_fit_one_cta(case):
    """Every tile's window, from its origin clamped to the domain, holds
    the tile widened by r*t on every side (columns rounded out to 16 bytes
    where the strip is a 16-byte multiple: the cp.async copies'
    alignment); the tile buffers hold its planes; every window cell is one
    unit of one thread (at most SHALLOW_UNITS a thread); the bands and
    buffers fit the CTA."""
    (shape, rows), r, t, eb = case
    lay = _shallow(shape, r, t, eb, rows)
    if lay is None:
        return
    H = shape[0]
    D1, D2 = _planes(shape)
    h, align = r * t, 16 // eb
    sy, sx = lay.strip
    left, wx = lay.window
    wy, wx2, left2, cells = stencil2d.shallow_geometry(shape, r, t, eb,
                                                       lay.strip, lay.rows)
    assert (left, wx) == (left2, wx2)
    aligned = sx % align == 0
    if aligned:
        assert left % align == 0 and wx % align == 0 and left >= h
    else:
        assert left == h and not lay.prefetch
    assert wy == (min(D1, sy + 2 * h) if len(shape) == 3 else 1)
    planes = min(H, lay.rows + 2 * h)
    assert cells % align == 0 and cells >= planes * wy * wx
    for s0, s1, y0, y1, x0, x1 in itertools.islice(_tiles(shape, lay, rows),
                                                   400):
        oi, ox = max(0, s0 - h), max(0, x0 - left)
        oy = max(0, y0 - h) if len(shape) == 3 else 0
        x_end = min(D2, x1 + h)
        if aligned:
            x_end = min(-(-D2 // align) * align, -(-x_end // align) * align)
            assert ox % align == 0
        assert min(H, s1 + h) - oi <= planes and x_end - ox <= wx
        assert (min(D1, y1 + h) if len(shape) == 3 else 1) - oy <= wy
    assert lay.segs == stencil2d.shallow_segs(wy * wx)
    assert wy * wx * lay.segs <= stencil2d.SHALLOW_UNITS * \
        stencil2d.SHALLOW_THREADS
    assert lay.scratch_bytes == (3 if t >= 3 and lay.prefetch else 2) \
        * cells * eb
    assert lay.smem <= LIMIT
    assert lay.band_bytes % 16 == 0


@pytest.mark.parametrize("eb", [4, 2])
@pytest.mark.parametrize("name", NAMES)
def test_shallow_layout_exists_where_the_planner_offers_it(name, eb):
    """Every shallow depth the planner sizes has a layout, with and
    without cached bands."""
    spec = get_spec(name)
    shape = (4096, 2048) if spec.ndim == 2 else (160, 160, 128)
    for t in (2, 4):
        R = plan_resident_planes(shape, eb, spec, chip=H100, fuse_steps=t)
        for rows in {0, R}:
            lay = _shallow(shape, spec.radius, t, eb, rows)
            assert lay is not None and lay.smem <= LIMIT, (t, rows)


def test_shallow_cost_counts_the_recomputed_halo():
    """shallow_pass_cost grows with the halo a tile recomputes (the radius
    at one depth and tile), and a tile of more rows costs less a cell (its
    halo rows are a smaller share)."""
    shape = (8192, 8192)
    cost = [stencil2d.shallow_pass_cost(shape, r, 4, 4, (1, 240), 64,
                                        H100.sms, 8192) for r in (1, 2, 4)]
    assert cost[0] < cost[1] < cost[2]
    short = stencil2d.shallow_pass_cost(shape, 1, 4, 4, (1, 248), 16,
                                        H100.sms, 8192)
    tall = stencil2d.shallow_pass_cost(shape, 1, 4, 4, (1, 248), 64,
                                       H100.sms, 8192)
    assert tall < short
