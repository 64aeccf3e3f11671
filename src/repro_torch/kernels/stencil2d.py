"""PERKS stencil kernels on Hopper: the port of ``repro/kernels/stencil2d.py``.

Four entry points with the reference's signatures, generic over 2D/3D
(blocking is along the leading axis; a 3D "row" is a whole plane), for
float32 and bfloat16 cells:

``stencil_perks``
    ``steps`` steps in ONE cooperative persistent launch; rows
    [0, cached_rows) stay in shared memory for the kernel's whole life, the
    rest stream between two device-memory ping-pong buffers. With
    ``fuse_steps=1`` they stream every step (``csrc/stencil_perks.cu``: a
    contiguous strip of rows a CTA, walked through a window of rows fed by
    bulk copies ahead of use; the cached planes in boxes, cut along the
    plane rows too where a plane is wider than a CTA's registers hold);
    with ``fuse_steps=t>1`` every t steps, in tiles that recompute an r*t
    halo (``csrc/stencil_shallow.cu``, the shallow schedule: each tile's
    window copied by ``cp.async`` while the previous tile's levels run, a
    thread walking fixed columns down its rows).
``stencil_perks_deep``
    t steps a pass with no recompute along the rows (``csrc/stencil_tb.cu``,
    the deep schedule): each CTA runs units of one strip by one segment of
    rows as a pipeline of levels, warp 0 feeding level-0 rows by TMA ahead
    of use, the other warps each computing its share of levels 1..t from
    small rings of rows in shared memory, meeting on mbarriers with no
    block-wide barrier in the row walk.
``stencil_resident``
    Every row cached (``csrc/stencil_resident.cu``): each CTA computes its
    band's new values into registers from shared memory, a block of rows
    at a time, and writes each block back r rows from its old place, with
    the neighbours' borders copied into halo rows by ``cp.async``
    (``resident_layout``); raises ``ValueError`` when the domain does not
    fit the co-resident CTAs' shared memory.
``stencil_baseline_step``
    One non-persistent, out-of-place step (``csrc/stencil_step.cu``): the
    loop tiers' step on the card. Each CTA walks a tile of the in-row cells
    down a segment of the leading axis through a ring of rows in shared
    memory fed by ``cp.async``, a thread taking 16 bytes of cells
    (``step_layout``).

The three persistent entry points also take ``[B, ...]``, B domains of the
spec's rank, in ONE cooperative launch: lane b runs on the CTAs (x, b) of a
grid (``lane_ctas``, B), with the layout one domain alone takes on that
many CTAs, so each lane gives its own run's bits; one grid barrier serves
every lane. A batch the card cannot hold raises ``ValueError``.

Dispatch: a CPU tensor runs the plain torch version (``ref.py``); a CUDA
tensor launches the hand kernel or raises — there is no fallback. Each
wrapper counts its launches in its ``launches`` attribute, and its batched
ones apart in ``batched_launches`` (``fused_batched_launches`` for
``stencil_perks``'s shallow tiles);
``stencil_perks`` counts the one-step launches whose window rows came by
bulk copies in ``window_launches``, its ``fuse_steps>1`` launches apart, in
``fused_launches``, and of those the ones whose tiles were copied by
``cp.async`` in ``fused_async_launches``; ``stencil_perks_deep`` counts
those that loaded level 0 by TMA in ``tma_launches``, and
``stencil_resident`` those whose halo rows were copied by ``cp.async`` in
``async_launches``, ``stencil_baseline_step`` its launches on rows not on
16-byte boundaries in ``unaligned_launches`` and those of specs that are
none of its compiled shapes in ``runtime_launches``. ``step_layout``,
``perks_layout``, ``tb_layout`` and ``resident_layout``
are the kernels' shared memory layouts, which the wrappers and the planner
share, so the planner offers no plan a kernel refuses.

Not ported yet (ROADMAP): temporal blocking of cached rows wider than one
CTA can hold (the one-step kernel cuts them into boxes).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.core.cache_policy import deep_window
from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.common import StencilSpec

#: Threads of the deep schedule's CTA (``csrc/stencil_tb.cu``) and the
#: widest row (cells) the persistent kernels' registers hold while a cached
#: row (a box's plane slab in the one-step kernel) is updated in place.
PERKS_THREADS = 1024
PERKS_MAX_ROW_CELLS = 20 * PERKS_THREADS
#: The one-step kernel (``csrc/stencil_perks.cu``): threads of a CTA and the
#: new values a thread holds while a block of a box's planes is updated in
#: place (their product is PERKS_MAX_ROW_CELLS); the threads that compute
#: the streamed rows (all warps but the one that feeds the window), the
#: window rows in flight ahead of the 2r + 1 in use, and the tile cells a
#: computing thread takes of a window row at most.
ONE_THREADS = 512
ONE_CELLS = 40
STREAM_THREADS = ONE_THREADS - 32
PERKS_STREAM_ROWS = 5
ONE_TILE_CELLS = 4
#: The one-step kernel's window of streamed rows: its shared memory at most,
#: in 2D (at 8192 f32 columns it leaves a CTA a band of 5 rows beside the
#: shift, one fewer than without it) and in 3D (taller tiles, fewer window
#: rows a step, for a few cached planes: PERF.md), and what a window row's
#: wait and release cost, in cells a thread, in choosing its tile
#: (``perks_window``; set by hand, not fitted).
PERKS_WINDOW_BYTES = 33 * 1024
PERKS_WINDOW_BYTES_3D = 64 * 1024
PERKS_ROW_CELLS = 1
#: Beside each window row the kernel keeps its points' offsets (a table of
#: STENCIL_MAX_POINTS int32s a slot, ``csrc/stencil_perks.cu``).
PERKS_OFFSET_BYTES = 4 * 32
#: Shared memory per CTA reserved for the persistent kernels' static
#: buffers (the spec, the row-pointer table). The planner and the wrappers
#: give a CTA the opt-in per-block limit less this reserve; the wrappers
#: check at each launch that the built kernel's static shared memory fits.
PERKS_STATIC_SMEM = 2048
#: ``csrc/stencil_resident.cu``: threads of a CTA and the new values a
#: thread holds in registers (a block of rows is at most their product,
#: never less than PERKS_MAX_ROW_CELLS). RES_BLOCK_CELLS prices a block's
#: barrier, in cells a thread, in ``resident_step_cost``: set by hand, not
#: fitted (the planner's RESIDENT_TERM_S is fitted with it, PERF.md).
RES_THREADS = 512
RES_CELLS = 40
RES_BLOCK_CELLS = 8
#: The shallow schedule (``csrc/stencil_shallow.cu``): threads of a CTA, the
#: units (window column by row segment) one thread may own, the most rows
#: of a tile; SHALLOW_LEVEL_CELLS and SHALLOW_TILE_CELLS price a level's
#: set-up and barrier and a tile's, in cells a thread, in
#: ``shallow_pass_cost``: set by hand, not fitted; they choose the tile
#: shape, and no recorded run times another shape against the one they
#: choose (PERF.md).
SHALLOW_THREADS = 512
SHALLOW_UNITS = 4
TB_TILE_ROWS = 128
SHALLOW_LEVEL_CELLS = 6
SHALLOW_TILE_CELLS = 12
#: Deep schedule: warp 0 keeps level-0 rows in flight into a ring of
#: 2r + 1 + DEEP_PREFETCH slots, DEEP_WARPS warps compute levels 1..t from
#: rings of 2r + 3 slots (less where those do not fit, ``deep_rings``).
#: DEEP_ROW_CELLS and DEEP_UNIT_TICKS price a warp's row (its waits and
#: arrivals, in cells a lane) and a unit's set-up (in ticks) in
#: ``deep_pass_cost``.
DEEP_PREFETCH = 3
DEEP_WARPS = PERKS_THREADS // 32 - 1
DEEP_ROW_CELLS = 4
DEEP_UNIT_TICKS = 16
#: The deep schedule's rows: its ring arithmetic (a multiply-high in place
#: of a division) is exact below this.
DEEP_MAX_ROWS = 2**23
#: The one-step kernel of the loop tiers (``csrc/stencil_step.cu``): threads
#: a CTA at most, rows (planes) in flight ahead of the 2r + 1 in use, and
#: 16-byte chunks of a ring slot a thread copies at most (the C source's
#: constants); threads across a tile row in 2D and in 3D; the shared memory
#: a 3D tile's ring may take before its tile gets fewer rows; the CTAs an
#: SM holds where the card is not asked (the wrapper asks it, and cuts the
#: leading axis into segments so that one wave of CTAs covers the
#: domain), and the fewest leading-axis rows a CTA walks. Set by hand, not
#: fitted.
STEP_THREADS = 256
STEP_PREFETCH = 3
STEP_FILL = 4
STEP_LANES_2D = 128
STEP_LANES_3D = 16
STEP_SMEM = 96 * 1024
STEP_CTAS_PER_SM = 8
STEP_MIN_SEG = 16
#: dtype -> the kernels' element-type code (STENCIL_F32, STENCIL_BF16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# -- layout arithmetic shared by the wrappers and the planner -----------------

def lane_ctas(max_ctas: int, lanes: int) -> int:
    """CTAs each lane of a batched launch of a persistent stencil kernel
    runs on: the ``max_ctas`` CTAs the card holds at once at the full
    per-block shared memory, shared evenly by ``lanes`` domains (0 where
    the lanes outnumber them). A lane is laid out as one domain alone on
    this many CTAs (the planner takes the card's SMs for ``max_ctas``: one
    such CTA an SM)."""
    return max_ctas // max(1, lanes)


def rows_per_cta(row_cells: int, dtype_bytes: int, radius: int,
                 smem_bytes: int, window_bytes: int = 0) -> int:
    """Cached rows one CTA can hold: its shared memory less the streamed
    rows' ``window_bytes`` (``perks_window``; 0 where nothing streams) and
    the ``radius`` rows an in-place update's blocks are shifted by; 0 for
    rows wider than the kernel's registers hold."""
    if row_cells > PERKS_MAX_ROW_CELLS:
        return 0
    return max(0, (smem_bytes - window_bytes) // (row_cells * dtype_bytes)
               - radius)


def band_layout(cached_rows: int, radius: int, ctas: int) -> tuple[int, int]:
    """``(bands, rows of the largest band)``: the cached rows are cut into
    at most ``ctas`` contiguous bands of at least ``radius`` rows each, so
    a neighbour's halo always lies in the adjacent band's published
    border."""
    if cached_rows == 0:
        return 0, 0
    nb = max(1, min(ctas, cached_rows // radius))
    return nb, -(-cached_rows // nb)


def band_smem_bytes(cached_rows: int, radius: int, row_bytes: int,
                    ctas: int, window_bytes: int = 0) -> int:
    """Dynamic shared memory one CTA needs: its band plus ``radius`` rows,
    and the streamed rows' ``window_bytes``."""
    nb, maxband = band_layout(cached_rows, radius, ctas)
    return (0 if nb == 0 else (maxband + radius) * row_bytes) + window_bytes


@dataclasses.dataclass(frozen=True)
class ResidentLayout:
    """One CTA of ``csrc/stencil_resident.cu``: ``nb`` bands of at most
    ``maxband`` rows; a step computes blocks of ``kb`` rows, a thread
    holding ``cells`` new values in registers (the block's cells
    ``RES_THREADS`` apart), each block written back r rows from its old
    place; ``halo``: r halo rows above and below the band take the
    neighbours' borders (the band and 3r rows), else the band takes r rows
    beside it and reads the rows outside it from device memory; ``smem``
    bytes of dynamic shared memory."""

    nb: int
    maxband: int
    kb: int
    cells: int
    halo: bool
    smem: int

    @property
    def blocks(self) -> int:
        return -(-self.maxband // self.kb)


def resident_layout(shape: tuple[int, ...], radius: int, dtype_bytes: int,
                    ctas: int, limit: int) -> Optional[ResidentLayout]:
    """The layout of ``csrc/stencil_resident.cu`` for the whole domain over
    ``ctas`` CTAs of ``limit`` bytes of shared memory, or None where it
    does not fit: exactly where ``rows_per_cta`` and ``band_smem_bytes``
    refuse it (without halo rows the band takes r rows beside it, as much
    as the one-step kernel's shift). The fewest blocks the registers allow,
    of even rows; halo rows where the band and 3r rows fit (and hold a
    cell whose every neighbour is in them)."""
    H = shape[0]
    P = math.prod(shape[1:])
    row = P * dtype_bytes
    if P > PERKS_MAX_ROW_CELLS or H == 0:
        return None
    nb, maxband = band_layout(H, radius, ctas)
    shift = band_smem_bytes(H, radius, row, ctas)
    if shift > limit:
        return None
    blocks = -(-maxband * P // (RES_THREADS * RES_CELLS))
    while True:
        kb = -(-maxband // blocks)
        cells = -(-kb * P // RES_THREADS)
        if cells <= RES_CELLS:
            break
        blocks += 1
    # with halo rows an idle slot sums at a cell whose every neighbour (at
    # most r rows, plane rows and columns away) lies in the storage
    D1, D2 = _planes(shape)
    reach = radius * P + (radius * D2 if len(shape) == 3 else 0) + radius
    halo = ((maxband + 3 * radius) * row <= limit
            and 2 * reach < (maxband + 3 * radius) * P)
    smem = (maxband + 3 * radius) * row if halo else shift
    return ResidentLayout(nb, maxband, kb, cells, halo, smem)


def resident_step_cost(lay: ResidentLayout) -> float:
    """One step of ``csrc/stencil_resident.cu`` in cells a thread: every
    block's cells a thread and RES_BLOCK_CELLS for its barrier."""
    return lay.blocks * (lay.cells + RES_BLOCK_CELLS)


@dataclasses.dataclass(frozen=True)
class PerksLayout:
    """One CTA of the one-step kernel (``csrc/stencil_perks.cu``): the
    cached planes in ``nbz`` bands of at most ``maxband`` planes, each cut
    into ``nby`` slabs of at most ``maxny`` plane rows (``nby`` = 1: whole
    planes, always in 2D), one box a CTA, stored with r halo plane rows on
    each cut side, and r planes they shift by (``box_bytes``, whole 16
    bytes);
    the streamed rows in ``nseg`` strips by tiles of ``strip`` = (plane
    rows, columns), whose window of ``slots`` tile rows is ``wy`` plane rows
    by ``window`` = (left, width) columns (``window_bytes``)."""

    nbz: int
    nby: int
    maxband: int
    maxny: int
    box_bytes: int
    strip: tuple[int, int] = (1, 1)
    window: tuple[int, int] = (0, 0)
    wy: int = 0
    slots: int = 0
    nseg: int = 0
    window_bytes: int = 0

    @property
    def smem(self) -> int:
        return self.box_bytes + self.window_bytes

    @property
    def boxes(self) -> int:
        return self.nbz * self.nby


@functools.lru_cache(maxsize=256)
def perks_window(shape: tuple[int, ...], radius: int, dtype_bytes: int
                 ) -> Optional[tuple]:
    """The one-step kernel's streamed tile and window, ``(strip, (left,
    width), wy, slots, bytes)``, or None: of tiles of ``strip`` = (plane
    rows, columns) (columns in 16-byte multiples that cut the row into
    nearly equal pieces; plane rows likewise in 3D, 1 in 2D) of at most
    ONE_TILE_CELLS cells a computing thread whose window of 2r + 1 +
    PERKS_STREAM_ROWS rows (each with PERKS_OFFSET_BYTES of its points'
    offsets) fits PERKS_WINDOW_BYTES (in 3D PERKS_WINDOW_BYTES_3D), the one
    whose rows cost
    the busiest thread least over a plane (its cells of a row, and
    PERKS_ROW_CELLS for the row's wait and release), then the one that
    reads the fewest window cells. A window row is the tile widened by r on
    every side, its columns from a 16-byte boundary (the left halo rounded
    up to 16 bytes) and clamped to the domain."""
    D1, D2 = _planes(shape)
    is3 = len(shape) == 3
    align = 16 // dtype_bytes
    left = -(-radius // align) * align
    whole = -(-D2 // align) * align
    slots = 2 * radius + 1 + PERKS_STREAM_ROWS
    cols = sorted({-(-(-(-D2 // n)) // align) * align for n in range(1, 65)}
                  | {align})
    heights = sorted({-(-D1 // n) for n in range(1, 65)}) if is3 else [1]
    best = None
    for sy in heights:
        wy = min(D1, sy + 2 * radius) if is3 else 1
        for sx in cols:
            cells = sy * min(sx, D2)
            if cells > STREAM_THREADS * ONE_TILE_CELLS:
                continue
            wx = min(whole, -(-(left + sx + radius) // align) * align)
            b = slots * (wy * wx * dtype_bytes + PERKS_OFFSET_BYTES)
            if b > (PERKS_WINDOW_BYTES_3D if is3 else PERKS_WINDOW_BYTES):
                continue
            tiles = -(-D1 // sy) * -(-D2 // sx)
            key = (tiles * (-(-cells // STREAM_THREADS) + PERKS_ROW_CELLS),
                   tiles * wy * wx)
            if best is None or key < best[0]:
                best = (key, (sy, sx), (left, wx), wy, slots, b)
    return None if best is None else best[1:]


@functools.lru_cache(maxsize=256)
def perks_strips(tiles: int, streamed: int, radius: int, ctas: int) -> int:
    """Strips the one-step kernel cuts ``streamed`` rows into: units are a
    strip of a tile, CTA b walks units b, b + ctas, ..., each its rows and
    r above and below; the fewest window rows the busiest CTA walks, the
    fewer strips on a tie."""
    best = None
    for nseg in range(1, min(streamed, 8 * ctas) + 1):
        cost = (-(-nseg * tiles // ctas)) * (-(-streamed // nseg) + 2 * radius)
        if best is None or cost < best[0]:
            best = (cost, nseg)
    return best[1]


def _slabs(D1: int, nby: int, radius: int) -> tuple[int, int]:
    """(plane rows of the largest slab, of the largest stored slab): D1
    plane rows cut into ``nby`` slabs, each stored with the r plane rows
    beside it on a cut side."""
    if nby == 1:
        return D1, D1
    cuts = [b * D1 // nby for b in range(nby + 1)]
    return (max(b - a for a, b in zip(cuts, cuts[1:])),
            max(min(D1, b + radius) - max(0, a - radius)
                for a, b in zip(cuts, cuts[1:])))


def _slab_counts(shape: tuple[int, ...], radius: int, ctas: int):
    """``(nby, largest slab, largest stored slab)`` for every cut of a
    plane into slabs of at least r plane rows whose updated cells a CTA's
    registers hold (2D: whole rows only)."""
    D1, D2 = _planes(shape)
    cuts = range(1, max(1, min(ctas, D1 // radius)) + 1) \
        if len(shape) == 3 else [1]
    for nby in cuts:
        maxny, stored = _slabs(D1, nby, radius)
        if maxny * D2 <= PERKS_MAX_ROW_CELLS:
            yield nby, maxny, stored


def perks_boxes(shape: tuple[int, ...], radius: int, dtype_bytes: int,
                ctas: int, cached_rows: int, budget: int
                ) -> Optional[tuple[int, int, int, int, int]]:
    """``(nbz, nby, maxband, maxny, bytes)`` of the one-step kernel's boxes
    for ``cached_rows`` planes within ``budget`` bytes, or None: the
    planes in at most ``ctas // nby`` bands of at least r planes
    (``band_layout``), each plane in the fewest slabs whose box and shift
    fit."""
    if cached_rows == 0:
        return 0, 1, 0, 0, 0
    D2 = shape[-1]
    for nby, maxny, stored in _slab_counts(shape, radius, ctas):
        nbz, maxband = band_layout(cached_rows, radius, ctas // nby)
        b = -(-(maxband + radius) * stored * D2 * dtype_bytes // 16) * 16
        if b <= budget:
            return nbz, nby, maxband, maxny, b
    return None


def perks_layout(shape: tuple[int, ...], radius: int, dtype_bytes: int,
                 ctas: int, limit: int, cached_rows: int
                 ) -> Optional[PerksLayout]:
    """The layout of ``csrc/stencil_perks.cu`` for ``cached_rows`` cached
    planes over ``ctas`` CTAs of ``limit`` bytes of shared memory, or None
    where it does not fit: the streamed rows' window (``perks_window``,
    none where every plane is cached) first, the boxes in what is left
    (``perks_boxes``), the strips by ``perks_strips``."""
    H = shape[0]
    streamed = H - cached_rows
    if streamed > 0:
        w = perks_window(tuple(shape), radius, dtype_bytes)
        if w is None:
            return None
        strip, window, wy, slots, wbytes = w
        D1, D2 = _planes(shape)
        tiles = -(-D1 // strip[0]) * -(-D2 // strip[1])
        nseg = perks_strips(tiles, streamed, radius, ctas)
    else:
        strip, window, wy, slots, wbytes, nseg = (1, 1), (0, 0), 0, 0, 0, 0
    boxes = perks_boxes(shape, radius, dtype_bytes, ctas, cached_rows,
                        limit - wbytes)
    if boxes is None:
        return None
    return PerksLayout(*boxes, strip, window, wy, slots, nseg, wbytes)


@functools.lru_cache(maxsize=256)
def perks_cached_rows(shape: tuple[int, ...], radius: int, dtype_bytes: int,
                      ctas: int, limit: int) -> int:
    """The most leading planes ``csrc/stencil_perks.cu`` caches with at
    least one row streamed: the boxes of every cut into slabs beside the
    window (``perks_window``), the cut that holds the most; 0 where no box
    of r planes fits."""
    H = shape[0]
    w = perks_window(tuple(shape), radius, dtype_bytes)
    if w is None or H < 2:
        return 0
    budget = (limit - w[4]) // 16 * 16
    best = 0
    for nby, _, stored in _slab_counts(shape, radius, ctas):
        per = budget // (stored * shape[-1] * dtype_bytes) - radius
        if per >= radius:
            best = max(best, min(H - 1, (ctas // nby) * per))
    return best if best >= radius else 0


def perks_step_cost(shape: tuple[int, ...], radius: int, lay: PerksLayout,
                    cached_rows: int, ctas: int) -> float:
    """One step of ``csrc/stencil_perks.cu`` in cells a thread of the
    busiest CTA: its box's stored cells over ONE_THREADS threads, and its
    streamed units' tile rows, each row's cells over STREAM_THREADS
    threads (the busiest one's) and PERKS_ROW_CELLS."""
    H = shape[0]
    D1, D2 = _planes(shape)
    box = lay.maxband * (min(D1, lay.maxny + (2 * radius if lay.nby > 1
                                               else 0)) * D2)
    stream = 0.0
    streamed = H - cached_rows
    if streamed > 0:
        sy, sx = lay.strip
        tiles = -(-D1 // sy) * -(-D2 // sx)
        waves = -(-lay.nseg * tiles // ctas)
        rows = -(-streamed // lay.nseg) + 2 * radius
        stream = waves * rows * (-(-sy * min(sx, D2) // STREAM_THREADS)
                                 + PERKS_ROW_CELLS)
    return box / ONE_THREADS + stream


@dataclasses.dataclass(frozen=True)
class TbLayout:
    """Shared memory of one CTA of the temporal-blocking kernels: ``nb``
    bands of at most ``maxband`` cached rows with their 2*r*t halo rows and
    r-row ring (``band_bytes``), then the streaming scratch
    (``scratch_bytes``) for strips of ``strip`` = (plane rows, columns)
    and, shallow (``csrc/stencil_shallow.cu``), tiles of ``rows`` rows
    whose windows' columns are ``window`` = (left, width)
    (``shallow_window``), whose levels are cut into ``segs`` row segments,
    and whose windows are copied while the last tile's levels run where
    ``prefetch``, or, deep (``csrc/stencil_tb.cu``), segments of ``rows``
    output rows with rings of ``rings`` = (level 0, levels 1..t-1) slots
    and level 0's columns ``window`` (``cache_policy.deep_window``)."""

    nb: int
    maxband: int
    band_bytes: int
    strip: tuple[int, int]
    rows: int
    scratch_bytes: int
    rings: tuple[int, int] = (0, 0)
    window: tuple[int, int] = (0, 0)
    segs: int = 0
    prefetch: bool = True

    @property
    def smem(self) -> int:
        return self.band_bytes + self.scratch_bytes


def _planes(shape: tuple[int, ...]) -> tuple[int, int]:
    """(D1, D2): plane rows and columns of a row (D1 = 1 in 2D)."""
    return (shape[1] if len(shape) == 3 else 1), shape[-1]


def deep_rings(radius: int) -> tuple[tuple[int, int], ...]:
    """Ring slots (level 0, levels 1..t-1) the deep schedule takes, the
    deepest first. Level k reads rows i - r .. i + r of level k - 1 while
    level k - 1 writes row i + r + 1 (a lag of r + 1 rows), so 2r + 2 slots
    a level is the least: with them the slot a level fills was freed a tick
    before, and a warp holding two adjacent levels (lowest first) never
    waits on itself. 2r + 3 lets a level run a row ahead; level 0 keeps
    DEEP_PREFETCH rows in flight beyond its 2r + 1, or none."""
    return ((2 * radius + 1 + DEEP_PREFETCH, 2 * radius + 3),
            (2 * radius + 1 + DEEP_PREFETCH, 2 * radius + 2),
            (2 * radius + 1, 2 * radius + 2))


def deep_scratch_bytes(shape: tuple[int, ...], radius: int, t: int,
                       dtype_bytes: int, strip: tuple[int, int],
                       rings: tuple[int, int]) -> int:
    """Streaming scratch of the deep schedule, as the kernel carves it
    from a 128-byte boundary: the rings of levels 0..t-1, ``rings`` = (level
    0's slots, each other level's) (level k >= 1 holds the strip widened by
    r*(t - k) on each side in slots padded to 16 bytes, level 0 its window,
    ``cache_policy.deep_window`` by the strip widened by r*t, in slots
    padded to 128 bytes), a full and an empty mbarrier per slot, and a
    table of t ring offsets."""
    is3 = len(shape) == 3
    sy, sx = strip
    q0, q = rings
    h = radius * t
    width0 = deep_window(sx, radius, t, dtype_bytes, len(shape))[1]

    def slot(cells: int, align: int) -> int:
        return -(-cells * dtype_bytes // align) * align

    ring0 = slot((sy + 2 * h if is3 else 1) * width0, 128)
    rest = sum(slot((sy + 2 * radius * m if is3 else 1)
                    * (sx + 2 * radius * m), 16) for m in range(1, t))
    return 128 + q0 * ring0 + q * rest + 16 * (q0 + (t - 1) * q) + 4 * t


def _deep_strips(shape, radius, t, dtype_bytes):
    """Strip widths the deep schedule takes, narrowest first, in classes:
    multiples of 16 bytes (TMA starts level 0's boxes there); in 2D a
    class is the widths of one level-0 window width, in 3D each width
    whose window is one box of at most 256 cells is its own."""
    ndim = len(shape)
    align = 16 // dtype_bytes
    top = -(-shape[-1] // align) * align
    classes = []
    for sx in range(align, top + 1, align):
        width = deep_window(sx, radius, t, dtype_bytes, ndim)[1]
        if ndim == 3 and width > 256:
            break
        if ndim == 2 and classes and deep_window(
                classes[-1][0], radius, t, dtype_bytes, 2)[1] == width:
            classes[-1].append(sx)
        else:
            classes.append([sx])
    return classes


def deep_pass_cost(shape, radius, t, strip, rows, ctas, streamed) -> float:
    """A deep pass of t levels over ``streamed`` rows in units of one
    ``strip`` by ``rows`` output rows, in cells a lane: every unit ticks
    once a row, for its rows, the 2 r t warm-up rows and the levels' lag
    of t (r + 1), plus DEEP_UNIT_TICKS; a tick costs the cells of the t
    levels over the 32 lanes of DEEP_WARPS warps, plus DEEP_ROW_CELLS; the
    units run ceil(units / ctas) waves."""
    D1, D2 = _planes(shape)
    is3 = len(shape) == 3
    sy, sx = strip
    cells = sum((sy + 2 * radius * m if is3 else 1) * (sx + 2 * radius * m)
                for m in range(t))
    tick = cells / (32 * DEEP_WARPS) + DEEP_ROW_CELLS
    units = -(-D1 // sy) * -(-D2 // sx) * -(-streamed // rows)
    ticks = rows + 2 * radius * t + t * (radius + 1) + DEEP_UNIT_TICKS
    return -(-units // ctas) * ticks * tick


@functools.lru_cache(maxsize=256)
def _deep_stream(shape, radius, t, dtype_bytes, ctas, budget, streamed):
    """The deep schedule's ``(strip, segment rows, bytes, rings)`` within
    ``budget`` bytes, or None: at the deepest rings (``deep_rings``) any
    strip fits with, the strip and segment of least ``deep_pass_cost``
    among the widest strip of each class of ``_deep_strips`` that fits
    whole; a class that fits only in part gives its widest strip that fits
    only where no class fits whole."""
    D1, D2 = _planes(shape)
    is3 = len(shape) == 3
    h = radius * t
    heights = sorted({min(D1, 1 << j) for j in range(9)} | {D1}) if is3 \
        else [1]
    for rings in deep_rings(radius):
        best = None
        for sy in heights:
            if is3 and sy + 2 * h > 256:
                break
            for cls in _deep_strips(shape, radius, t, dtype_bytes):
                fit = [(sx, b) for sx in cls
                       for b in [deep_scratch_bytes(
                           shape, radius, t, dtype_bytes, (sy, sx), rings)]
                       if b <= budget]
                if not fit or (best is not None and len(fit) < len(cls)):
                    break
                sx, b = fit[-1]
                tiles = -(-D1 // sy) * -(-D2 // sx)
                segs = {1, streamed}
                for waves in range(1, 9):
                    f = waves * ctas / tiles
                    segs |= {max(1, min(streamed, int(f))),
                             max(1, min(streamed, -(-waves * ctas // tiles)))}
                for nseg in segs:
                    rows = -(-streamed // nseg)
                    cost = deep_pass_cost(shape, radius, t, (sy, sx), rows,
                                          ctas, streamed)
                    key = (cost, -sx * sy, rows)
                    if best is None or key < best[0]:
                        best = (key, (sy, sx), rows, b, rings)
        if best is not None:
            return best[1:]
    return None


def shallow_window(strip_cols: int, radius: int, t: int,
                   dtype_bytes: int) -> tuple[int, int]:
    """``(left, width)``: the shallow schedule's window columns [x0 - left,
    x0 - left + width) for a strip of ``strip_cols`` columns from x0, before
    clamping to the domain: the r*t halo on each side, rounded out to 16
    bytes where the strip is a 16-byte multiple (then every row of a window
    is whole 16-byte copies)."""
    h = radius * t
    align = 16 // dtype_bytes
    if strip_cols % align:
        return h, strip_cols + 2 * h
    left = -(-h // align) * align
    return left, -(-(left + strip_cols + h) // align) * align


def shallow_geometry(shape: tuple[int, ...], radius: int, t: int,
                     dtype_bytes: int, strip: tuple[int, int],
                     rows: int) -> tuple[int, int, int, int]:
    """``(wy, wx, left, buf_cells)`` of a shallow tile, its window clamped to
    the domain: the window's plane rows (the strip's widened by r*t; 1 in
    2D) and columns (``shallow_window``), and the cells of one tile buffer
    (rows + 2rt window planes, whole 16 bytes)."""
    D1, D2 = _planes(shape)
    sy, sx = strip
    h = radius * t
    align = 16 // dtype_bytes
    left, wx = shallow_window(sx, radius, t, dtype_bytes)
    wx = min(wx, -(-D2 // align) * align)
    wy = min(D1, sy + 2 * h) if len(shape) == 3 else 1
    planes = min(shape[0], rows + 2 * h)
    return wy, wx, left, -(-planes * wy * wx // align) * align


def shallow_scratch_bytes(shape: tuple[int, ...], radius: int, t: int,
                          dtype_bytes: int, strip: tuple[int, int],
                          rows: int, prefetch: bool = True) -> int:
    """Streaming scratch of one CTA of the shallow schedule: the level-0
    buffer and the levels' two, or one at t = 2 (level t goes to device
    memory) or without ``prefetch`` (level 0's buffer then takes every
    second level, and a tile's window is copied only once the last tile's
    levels are done)."""
    cells = shallow_geometry(shape, radius, t, dtype_bytes, strip, rows)[3]
    return (3 if t >= 3 and prefetch else 2) * cells * dtype_bytes


def shallow_segs(area: int) -> int:
    """Row segments of a level for a window plane of ``area`` cells: as
    many as SHALLOW_THREADS threads take at one unit each."""
    return max(1, SHALLOW_THREADS // area)


def shallow_pass_cost(shape: tuple[int, ...], radius: int, t: int,
                      dtype_bytes: int, strip: tuple[int, int], rows: int,
                      ctas: int, streamed: int) -> float:
    """A shallow pass of t levels over ``streamed`` rows in tiles of one
    ``strip`` by ``rows`` rows, in cells a thread: at level k every thread
    walks its units' segments of the tile's rows widened by r*(t - k), plus
    SHALLOW_LEVEL_CELLS, and a tile adds SHALLOW_TILE_CELLS; the tiles run
    ceil(tiles / ctas) waves."""
    D1, D2 = _planes(shape)
    sy, sx = strip
    wy, wx, _, _ = shallow_geometry(shape, radius, t, dtype_bytes, strip,
                                    rows)
    segs = shallow_segs(wy * wx)
    units = -(-wy * wx * segs // SHALLOW_THREADS)
    tile = SHALLOW_TILE_CELLS + sum(
        units * -(-min(shape[0], rows + 2 * radius * (t - k)) // segs)
        + SHALLOW_LEVEL_CELLS for k in range(1, t + 1))
    tiles = -(-streamed // rows) * -(-D1 // sy) * -(-D2 // sx)
    return -(-tiles // ctas) * tile


def band_pass_cost(shape: tuple[int, ...], radius: int, t: int,
                   maxband: int, threads: int) -> float:
    """A pass of t levels over a cached band of ``maxband`` rows
    (``csrc/stencil_band.cuh``), in cells a thread: level k updates the
    band widened by r*(t - k) on each side, its rows' cells spread over
    ``threads`` threads."""
    P = math.prod(shape[1:])
    return sum((maxband + 2 * radius * (t - k)) * P / threads
               for k in range(1, t + 1))


@functools.lru_cache(maxsize=256)
def _shallow_stream(shape, radius, t, dtype_bytes, ctas, budget, streamed):
    """The shallow schedule's ``(strip, rows, bytes, window, segs,
    prefetch)`` within ``budget`` bytes, or None: of strips whose window
    plane is at most SHALLOW_UNITS * SHALLOW_THREADS cells (16-byte
    multiples of columns whose windows are a power of two columns, or the
    whole width; narrower strips only where none of those fits) and tiles
    of up to TB_TILE_ROWS rows, the one of least ``shallow_pass_cost``, the
    larger tile on a tie; without prefetch only where nothing fits with
    it."""
    D1, D2 = _planes(shape)
    is3 = len(shape) == 3
    align = 16 // dtype_bytes
    h = radius * t
    left = -(-h // align) * align
    whole = -(-D2 // align) * align
    cols = {align, whole}
    for j in range(4, 12):
        sx = ((1 << j) - left - h) // align * align
        if align <= sx < whole:
            cols.add(sx)
    heights = sorted({min(D1, 1 << j) for j in range(7)} | {D1}) if is3 \
        else [1]
    tall = sorted({min(streamed, 1 << j) for j in range(8)
                   if (1 << j) <= TB_TILE_ROWS} | {min(streamed,
                                                       TB_TILE_ROWS)})
    narrow = [1 << j for j in range(4) if (1 << j) < min(align, D2)]
    for prefetch, strips in ((True, sorted(cols)), (False, sorted(cols)),
                             (False, narrow)):
        best = None
        for sy in heights:
            for sx in strips:
                wy, wx, left, _ = shallow_geometry(shape, radius, t,
                                                   dtype_bytes, (sy, sx), 1)
                if wy * wx > SHALLOW_UNITS * SHALLOW_THREADS:
                    continue
                for rows in tall:
                    b = shallow_scratch_bytes(shape, radius, t, dtype_bytes,
                                              (sy, sx), rows, prefetch)
                    if b > budget:
                        break
                    cost = shallow_pass_cost(shape, radius, t, dtype_bytes,
                                             (sy, sx), rows, ctas, streamed)
                    key = (cost, -rows * sy * sx)
                    if best is None or key < best[0]:
                        best = (key, (sy, sx), rows, b, (left, wx),
                                shallow_segs(wy * wx), prefetch)
        if best is not None:
            return best[1:]
    return None


def tb_least_scratch(shape: tuple[int, ...], radius: int, t: int,
                     dtype_bytes: int, deep: bool) -> int:
    """The smallest streaming scratch the kernel can run t steps a pass
    with (shallow: a one-cell strip, one row, no prefetch; deep: the
    narrowest level-0 window at the shallowest rings)."""
    if not deep:
        return shallow_scratch_bytes(shape, radius, t, dtype_bytes, (1, 1),
                                     1, prefetch=False)
    return deep_scratch_bytes(shape, radius, t, dtype_bytes,
                              (1, 16 // dtype_bytes), deep_rings(radius)[-1])


def tb_layout(shape: tuple[int, ...], radius: int, t: int, dtype_bytes: int,
              *, deep: bool, ctas: int, limit: int,
              cached_rows: int) -> Optional[TbLayout]:
    """The layout of the temporal-blocking kernel (deep:
    ``csrc/stencil_tb.cu``, shallow: ``csrc/stencil_shallow.cu``) for
    ``cached_rows`` cached rows and t steps a pass over ``ctas`` CTAs of
    ``limit`` bytes of shared memory, or None when it does not fit: the
    bands (``band_layout``, full rows held in place, so at most
    PERKS_MAX_ROW_CELLS cells a row) come first, the streaming scratch
    takes what is left."""
    H = shape[0]
    row_cells = math.prod(shape[1:])
    nb, maxband = band_layout(cached_rows, radius, ctas)
    if nb and row_cells > PERKS_MAX_ROW_CELLS:
        return None
    band = 0 if nb == 0 else -(-(maxband + 2 * radius * t + radius)
                               * row_cells * dtype_bytes // 16) * 16
    if band > limit:
        return None
    if cached_rows >= H:
        return TbLayout(nb, maxband, band, (1, 1), 1, 0)
    if deep:
        stream = _deep_stream(shape, radius, t, dtype_bytes, ctas,
                              limit - band, H - cached_rows)
        if stream is None:
            return None
        strip, rows, scratch, rings = stream
        return TbLayout(nb, maxband, band, strip, rows, scratch, rings,
                        deep_window(strip[1], radius, t, dtype_bytes,
                                    len(shape)))
    stream = _shallow_stream(shape, radius, t, dtype_bytes, ctas,
                             limit - band, H - cached_rows)
    if stream is None:
        return None
    strip, rows, scratch, window, segs, prefetch = stream
    return TbLayout(nb, maxband, band, strip, rows, scratch, window=window,
                    segs=segs, prefetch=prefetch)


def tb_cached_rows(shape: tuple[int, ...], radius: int, t: int,
                   dtype_bytes: int, *, deep: bool, ctas: int,
                   limit: int) -> Optional[int]:
    """Cached rows the planner gives the temporal-blocking kernel: bands of
    at most half a CTA's shared memory (halo rows and ring included), so
    the streaming scratch keeps the other half; 0 where no band fits, None
    where the kernel cannot run t steps a pass at all."""
    if tb_layout(shape, radius, t, dtype_bytes, deep=deep, ctas=ctas,
                 limit=limit, cached_rows=0) is None:
        return None
    H = shape[0]
    row_bytes = math.prod(shape[1:]) * dtype_bytes
    per = (limit // 2) // row_bytes - 2 * radius * t - radius
    rows = min(H, ctas * per) if per >= 1 else 0
    if rows < min(radius, H):
        return 0
    if tb_layout(shape, radius, t, dtype_bytes, deep=deep, ctas=ctas,
                 limit=limit, cached_rows=rows) is None:
        return 0
    return rows


@dataclasses.dataclass(frozen=True)
class StepLayout:
    """The launch of ``csrc/stencil_step.cu`` for one (spec, shape, dtype,
    B): a CTA owns a tile of ``rows`` plane rows (1 in 2D) by ``lanes *
    vec`` cells and walks ``seg`` leading-axis rows of it, with a ring of
    ``slots`` slots of ``slot`` cells in shared memory (each slot the tile's
    rows and their r-row halo in 3D, rows ``span`` cells wide: the tile's
    cells and ``ra`` halo cells each side). The grid is ``tiles_x *
    tiles_y`` tiles by ``segs`` segments by ``batch`` instances.
    ``row_aligned``: every row starts on a 16-byte boundary (the kernel
    then copies and stores 16-byte chunks)."""

    vec: int
    lanes: int
    rows: int
    ra: int
    span: int
    slot: int
    slots: int
    seg: int
    segs: int
    tiles_x: int
    tiles_y: int
    batch: int
    dtype_bytes: int
    row_aligned: bool

    @property
    def threads(self) -> int:
        return self.lanes * self.rows

    @property
    def smem(self) -> int:
        return self.slots * self.slot * self.dtype_bytes

    @property
    def grid(self) -> tuple[int, int, int]:
        return (self.tiles_x * self.tiles_y, self.segs, self.batch)

    @functools.cached_property
    def c_args(self) -> tuple[_build.StepArgs, _build.StepArgs]:
        """The C struct, for unaligned (0) and aligned (1) tensors."""
        out = []
        for aligned in (0, 1):
            g = _build.StepArgs()
            g.lanes, g.rows, g.ra, g.span = (self.lanes, self.rows, self.ra,
                                             self.span)
            g.slot, g.slots, g.seg, g.tiles_x = (self.slot, self.slots,
                                                 self.seg, self.tiles_x)
            g.aligned = aligned
            out.append(g)
        return tuple(out)


@functools.lru_cache(maxsize=256)
def step_layout(spec: StencilSpec, shape: tuple[int, ...], dtype_bytes: int,
                batch: int = 1, sms: int = 132,
                limit: int = 232448 - PERKS_STATIC_SMEM,
                per_sm: int = STEP_CTAS_PER_SM) -> StepLayout:
    """The launch geometry of one step of ``spec`` on B = ``batch`` domains
    of ``shape`` with ``dtype_bytes``-byte cells, on a card of ``sms`` SMs
    whose CTA may take ``limit`` bytes of shared memory and of which each
    holds ``per_sm`` of its CTAs: as many segments of the leading axis as
    one wave of CTAs takes (the tile, its threads and its shared memory do
    not depend on ``per_sm``). Raises ``ValueError`` naming the spec and
    shape when no tile fits."""
    r, nd = spec.radius, spec.ndim
    H, D2 = shape[0], shape[-1]
    D1 = shape[1] if nd == 3 else 1
    vec = 16 // dtype_bytes
    ra = -(-r // vec) * vec
    ry = r if nd == 3 else 0
    cols = -(-D2 // vec)
    slots = 2 * r + 1 + STEP_PREFETCH

    def sizes(lanes, rows):
        span = lanes * vec + 2 * ra
        return span, (rows + 2 * ry) * span

    def fits(lanes, rows):
        return ((rows + 2 * ry) * (lanes + 2 * ra // vec)
                <= STEP_FILL * lanes * rows
                and lanes * rows <= STEP_THREADS)

    if nd == 2:
        lanes, rows = min(STEP_LANES_2D, -(-cols // 32) * 32), 1
    else:
        lanes = min(STEP_LANES_3D, max(4, cols))
        rows = min(STEP_THREADS // lanes, D1)
        while not fits(lanes, rows) and 2 * lanes * rows <= STEP_THREADS:
            rows *= 2
        while (rows > 1 and slots * sizes(lanes, rows)[1] * dtype_bytes
               > STEP_SMEM and fits(lanes, rows // 2)):
            rows //= 2
    span, slot = sizes(lanes, rows)
    if not fits(lanes, rows) or slots * slot * dtype_bytes > limit:
        raise ValueError(
            f"{spec.name} on {tuple(shape)}: no tile of the step kernel fits "
            f"(radius {r}, {lanes} x {rows} threads, a ring of {slots} "
            f"slots of {slot * dtype_bytes} B against {limit} B of shared "
            f"memory)")
    tiles_x, tiles_y = -(-D2 // (lanes * vec)), -(-D1 // rows)
    segs = max(1, min(per_sm * sms // (tiles_x * tiles_y * batch),
                      H // STEP_MIN_SEG))
    seg = -(-H // segs)
    segs = -(-H // seg)
    if tiles_x * tiles_y >= 2**31 or segs > 65535 or batch > 65535:
        raise ValueError(f"{spec.name} on {tuple(shape)} x {batch}: the "
                         f"step kernel's grid is too large")
    return StepLayout(vec, lanes, rows, ra, span, slot, slots, seg, segs,
                      tiles_x, tiles_y, batch, dtype_bytes,
                      D2 * dtype_bytes % 16 == 0)


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _step_per_sm(spec: StencilSpec, shape: tuple[int, ...], dtype: int,
                 threads: int, smem: int, index: int) -> int:
    """CTAs of the step kernel for ``spec`` one SM of card ``index`` holds
    (``stencil_step_per_sm``: its registers and shared memory)."""
    n = ctypes.c_int()
    _build.check(_build.load("stencil_step").stencil_step_per_sm(
        stencil_args(spec, shape), dtype, threads, smem, ctypes.byref(n)),
        "stencil_step_per_sm")
    if n.value < 1:
        raise ValueError(f"{spec.name} on {shape}: no CTA of the step kernel "
                         f"({threads} threads, {smem} B) fits an SM")
    return n.value


# -- argument checks -----------------------------------------------------------

def _lanes(x: torch.Tensor, spec: StencilSpec) -> tuple[tuple[int, ...], int]:
    """(one domain's shape, lanes): ``x`` is one domain of the spec's rank,
    or ``[B, ...]``, B of them."""
    if x.dim() == spec.ndim + 1:
        return tuple(x.shape[1:]), x.shape[0]
    return tuple(x.shape), 1


def _check_perks_args(x, spec: StencilSpec, steps: int, cached_rows: int,
                      sub_rows: int, fuse_steps: int, deep: bool = False
                      ) -> None:
    """The reference's kernel preconditions, raised as ``ValueError``: the
    deep schedule's block needs one level's halo, the shallow schedule's
    tile the fused r*t halo."""
    H, r = _lanes(x, spec)[0][0], spec.radius
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if fuse_steps < 1:
        raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
    if not 0 <= cached_rows <= H:
        raise ValueError(f"cached_rows={cached_rows} outside [0, {H}]")
    if cached_rows not in (0, H) and cached_rows < r:
        raise ValueError("partial caching needs at least `radius` resident "
                         f"rows (cached_rows={cached_rows} < radius={r})")
    if deep and sub_rows < r:
        raise ValueError("deep schedule needs one level's halo per block "
                         f"(sub_rows >= radius = {r}, got {sub_rows})")
    if not deep and sub_rows < r * min(fuse_steps, steps):
        raise ValueError(
            "subtile must cover the next subtile's fused halo "
            f"(sub_rows >= radius*fuse_steps = {r * min(fuse_steps, steps)})")


def _check_cuda(x: torch.Tensor, spec: StencilSpec,
                batched: bool = False) -> None:
    """Raise on what the kernels do not take; ``batched``: ``x`` may also
    be ``[B, ...]``, B domains (each held to the limits of one)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"the CUDA stencil kernels take float32 or bfloat16, "
                        f"got {x.dtype}")
    if (x.dim() not in ((spec.ndim, spec.ndim + 1) if batched
                        else (spec.ndim,)) or spec.ndim not in (2, 3)):
        raise ValueError(f"{spec.name} needs a {spec.ndim}D domain"
                         f"{' or a batch of them' if batched else ''}, got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the CUDA stencil kernels take contiguous tensors")
    cells = math.prod(_lanes(x, spec)[0])
    if cells >= 2**31:
        raise ValueError(f"domain of {cells} cells exceeds 32-bit "
                         f"indexing")
    if spec.npoints > _build.MAX_POINTS or not 1 <= spec.radius <= _build.MAX_RADIUS:
        raise ValueError(f"{spec.name}: the kernels take at most "
                         f"{_build.MAX_POINTS} points and radius 1.."
                         f"{_build.MAX_RADIUS}")


@functools.lru_cache(maxsize=64)
def stencil_args(spec: StencilSpec, shape: tuple[int, ...]) -> _build.StencilArgs:
    """The kernels' by-value description of ``spec`` on a domain ``shape``
    (cached: the loop tiers launch with the same one every step)."""
    D2 = shape[-1]
    D1 = shape[1] if spec.ndim == 3 else 1
    a = _build.StencilArgs()
    a.H, a.D1, a.D2 = shape[0], D1, D2
    a.P, a.ndim, a.r, a.npts = D1 * D2, spec.ndim, spec.radius, spec.npoints
    for k, (off, w) in enumerate(zip(spec.offsets, spec.weights)):
        a.d0[k] = off[0]
        a.d1[k] = off[1] if spec.ndim == 3 else 0
        a.d2[k] = off[-1]
        a.dc[k] = a.d1[k] * D2 + a.d2[k]
        a.w[k] = w
    return a


def _limit(lib, prefix: str, spec: StencilSpec, x: torch.Tensor) -> int:
    """Dynamic shared memory a CTA of kernel ``prefix`` may take: the
    card's opt-in maximum less PERKS_STATIC_SMEM, after checking that the
    built kernel's static shared memory fits in that reserve."""
    optin, static = ctypes.c_int(), ctypes.c_int()
    _build.check(getattr(lib, f"{prefix}_smem")(
        spec.npoints, DTYPES[x.dtype], ctypes.byref(optin),
        ctypes.byref(static)), f"{prefix}_smem")
    if static.value > PERKS_STATIC_SMEM:
        raise RuntimeError(
            f"the built {prefix} kernel takes {static.value} B of static "
            f"shared memory, more than the {PERKS_STATIC_SMEM} B that "
            f"stencil2d.PERKS_STATIC_SMEM reserves for it")
    return optin.value - PERKS_STATIC_SMEM


@functools.lru_cache(maxsize=256)
def _co_resident(prefix: str, npoints: int, dtype: int, smem: int,
                 index: int) -> int:
    """Co-resident CTAs of kernel ``prefix`` at ``smem`` bytes each on card
    ``index`` (its ``<prefix>_max_ctas``: registers and shared memory)."""
    grid = ctypes.c_int()
    _build.check(getattr(_build.load(prefix), f"{prefix}_max_ctas")(
        npoints, dtype, smem, ctypes.byref(grid)), f"{prefix}_max_ctas")
    return grid.value


def _lane_ctas(prefix: str, spec: StencilSpec, x: torch.Tensor, limit: int,
               lanes: int) -> int:
    """``lane_ctas`` of kernel ``prefix`` on ``x``'s card: its co-resident
    CTAs at the full ``limit`` bytes each over ``lanes`` domains; raises
    ``ValueError`` where the lanes outnumber them."""
    full = _co_resident(prefix, spec.npoints, DTYPES[x.dtype], limit,
                        x.device.index)
    ctas = lane_ctas(full, lanes)
    if ctas < 1:
        raise ValueError(f"{lanes} lanes of {prefix} need a co-resident CTA "
                         f"each; the card runs {full} with {limit} B each")
    return ctas


def _grid(prefix: str, spec: StencilSpec, x: torch.Tensor, smem: int,
          nb: int, lanes: int = 1, ctas: int = 0) -> int:
    """The CTAs a lane of kernel ``prefix`` launches with at ``smem`` bytes
    each: for one domain every co-resident CTA, for B = ``lanes`` > 1
    domains the ``ctas`` a lane was laid out on. Raises ``ValueError`` when
    the ``nb`` bands of one domain, or the lanes' ``lanes * ctas`` CTAs, are
    not all co-resident."""
    grid = _co_resident(prefix, spec.npoints, DTYPES[x.dtype], smem,
                        x.device.index)
    need = max(nb, 1) if lanes == 1 else lanes * ctas
    if grid < need:
        what = f"{nb} bands" if lanes == 1 else f"{lanes} lanes of {ctas}"
        raise ValueError(f"{what} need {need} co-resident CTAs, the card "
                         f"runs {grid} with {smem} B each")
    return grid if lanes == 1 else ctas


# -- the persistent kernels ---------------------------------------------------

def _launch_perks(x: torch.Tensor, spec: StencilSpec, steps: int,
                  cached_rows: int) -> tuple[torch.Tensor, bool]:
    """Launch ``csrc/stencil_perks.cu`` on a checked CUDA tensor (one
    domain or a batch): the result, and whether its window rows were bulk
    copies."""
    lib = _build.load("stencil_perks")
    built = [ctypes.c_int() for _ in range(4)]
    lib.stencil_perks_shape(*(ctypes.byref(v) for v in built))
    if tuple(v.value for v in built) != (ONE_THREADS, ONE_CELLS,
                                        PERKS_STREAM_ROWS, ONE_TILE_CELLS):
        raise RuntimeError("csrc/stencil_perks.cu and stencil2d.py disagree "
                           "on ONE_THREADS / ONE_CELLS / PERKS_STREAM_ROWS / "
                           "ONE_TILE_CELLS")
    r = spec.radius
    shape, lanes = _lanes(x, spec)
    eb = x.element_size()
    with _build.on_device(x):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        limit = _limit(lib, "stencil_perks", spec, x)
        ctas = _lane_ctas("stencil_perks", spec, x, limit, lanes)
        lay = perks_layout(shape, r, eb, ctas, limit, cached_rows)
        if lay is None:
            cap = perks_cached_rows(shape, r, eb, ctas, limit)
            raise ValueError(
                f"cannot cache {cached_rows} planes of {shape[1:]} {x.dtype} "
                f"cells: the boxes, their {r}-plane shift and the streamed "
                f"rows' window do not fit one CTA's {limit} B of shared "
                f"memory, so the kernel holds at most {cap} planes of this "
                f"shape over {ctas} CTAs{_a_lane(lanes)} with rows streamed "
                f"(a box's plane slab is at most {PERKS_MAX_ROW_CELLS} cells)")
        grid = min(sms, _grid("stencil_perks", spec, x, lay.smem, lay.boxes,
                              lanes, ctas))
        g = _build.PerksArgs(steps, cached_rows, lay.nbz, lay.nby,
                             lay.box_bytes, lay.strip[0], lay.strip[1],
                             lay.window[0], lay.window[1], lay.wy, lay.nseg,
                             lay.slots)
        buf0 = torch.empty_like(x)
        buf1 = torch.empty_like(x)
        fed = ctypes.c_int()
        err = lib.stencil_perks_launch(
            x.data_ptr(), buf0.data_ptr(), buf1.data_ptr(),
            stencil_args(spec, shape), g, DTYPES[x.dtype], grid, lanes,
            lay.smem, _build.stream(), ctypes.byref(fed))
    _build.check(err, "stencil_perks_launch")
    return (buf0 if (steps - 1) % 2 == 0 else buf1), bool(fed.value)


def _a_lane(lanes: int) -> str:
    """How an error message names a lane's CTAs."""
    return f" (a lane of {lanes})" if lanes > 1 else ""


def _launch_resident(x: torch.Tensor, spec: StencilSpec,
                     steps: int) -> tuple[torch.Tensor, bool]:
    """Launch ``csrc/stencil_resident.cu`` on a checked CUDA tensor (one
    domain or a batch): the result, and whether the halo rows were copied
    by ``cp.async``."""
    lib = _build.load("stencil_resident")
    threads, cells = ctypes.c_int(), ctypes.c_int()
    lib.stencil_resident_shape(ctypes.byref(threads), ctypes.byref(cells))
    if (threads.value, cells.value) != (RES_THREADS, RES_CELLS):
        raise RuntimeError("csrc/stencil_resident.cu and stencil2d.py "
                           "disagree on RES_THREADS / RES_CELLS")
    r = spec.radius
    shape, lanes = _lanes(x, spec)
    row_cells = math.prod(shape[1:])
    with _build.on_device(x):
        limit = _limit(lib, "stencil_resident", spec, x)
        ctas = _lane_ctas("stencil_resident", spec, x, limit, lanes)
        lay = resident_layout(shape, r, x.element_size(), ctas, limit)
        if lay is None:
            cap = ctas * rows_per_cta(row_cells, x.element_size(), r, limit)
            raise ValueError(
                f"cannot keep {shape[0]} rows of {row_cells} {x.dtype} "
                f"cells on chip: a band plus r = {r} rows must fit one "
                f"CTA's {limit} B of shared memory, so the kernel holds at "
                f"most {cap} rows of this width over {ctas} CTAs"
                f"{_a_lane(lanes)} (rows wider than {PERKS_MAX_ROW_CELLS} "
                f"cells are not cached)")
        grid = _grid("stencil_resident", spec, x, lay.smem, lay.nb, lanes,
                     ctas)
        g = _build.ResArgs(steps, lay.nb, lay.kb, 0, 0, int(lay.halo))
        buf0 = torch.empty_like(x)
        buf1 = torch.empty_like(x)
        copied = ctypes.c_int()
        err = lib.stencil_resident_launch(
            x.data_ptr(), buf0.data_ptr(), buf1.data_ptr(),
            stencil_args(spec, shape), g, DTYPES[x.dtype], grid, lanes,
            lay.smem, _build.stream(), ctypes.byref(copied))
    _build.check(err, "stencil_resident_launch")
    return (buf0 if (steps - 1) % 2 == 0 else buf1), bool(copied.value)


def _launch_tb(x: torch.Tensor, spec: StencilSpec, steps: int, t: int,
               cached_rows: int, deep: bool) -> tuple[torch.Tensor, bool]:
    """Launch a temporal-blocking kernel on a checked CUDA tensor (one
    domain or a batch), t steps a pass: deep level pipelines
    (``csrc/stencil_tb.cu``) or shallow tiles (``csrc/stencil_shallow.cu``).
    Returns the result, and whether level 0 came by the asynchronous route
    (deep: TMA; shallow: ``cp.async``)."""
    name = "stencil_tb" if deep else "stencil_shallow"
    lib = _build.load(name)
    if deep:
        widest = lib.stencil_tb_max_row_cells()
    else:
        threads, units, cells = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        lib.stencil_shallow_shape(ctypes.byref(threads), ctypes.byref(units),
                                  ctypes.byref(cells))
        widest = cells.value
        if (threads.value, units.value) != (SHALLOW_THREADS, SHALLOW_UNITS):
            raise RuntimeError("csrc/stencil_shallow.cu and stencil2d.py "
                               "disagree on SHALLOW_THREADS / SHALLOW_UNITS")
    if widest != PERKS_MAX_ROW_CELLS:
        raise RuntimeError("csrc/stencil_common.cuh and stencil2d.py "
                           "disagree on the widest cached row")
    r = spec.radius
    shape, lanes = _lanes(x, spec)
    eb = x.element_size()
    with _build.on_device(x):
        limit = _limit(lib, name, spec, x)
        ctas = _lane_ctas(name, spec, x, limit, lanes)
        lay = tb_layout(shape, r, t, eb, deep=deep, ctas=ctas, limit=limit,
                        cached_rows=cached_rows)
        if lay is None:
            nb, maxband = band_layout(cached_rows, r, ctas)
            band = (maxband + 2 * r * t + r) * math.prod(shape[1:]) * eb \
                if nb else 0
            least = tb_least_scratch(shape, r, t, eb, deep)
            raise ValueError(
                f"{'stencil_perks_deep' if deep else 'stencil_perks'} "
                f"cannot run {spec.name} on {shape} {x.dtype} at "
                f"{t} steps a pass (r*t = {r * t}-cell halos) with "
                f"{cached_rows} cached rows over {ctas} CTAs{_a_lane(lanes)}: "
                f"the bands need {band} B of shared memory per CTA and the "
                f"smallest streaming layout {least} B more, and a CTA has "
                f"{limit} B (cached rows are at most {PERKS_MAX_ROW_CELLS} "
                f"cells wide)")
        grid = _grid(name, spec, x, lay.smem, lay.nb, lanes, ctas)
        if deep:
            g = _build.TbArgs(steps, t, cached_rows, lay.nb, lay.strip[0],
                              lay.strip[1], lay.rows, lay.band_bytes,
                              *lay.rings, *lay.window)
        else:
            wy, wx, left, cells = shallow_geometry(shape, r, t, eb, lay.strip,
                                                   lay.rows)
            g = _build.ShallowArgs(steps, t, cached_rows, lay.nb,
                                   lay.strip[0], lay.strip[1], lay.rows, left,
                                   wx, wy, lay.segs, int(lay.prefetch),
                                   lay.band_bytes, cells)
        buf0 = torch.empty_like(x)
        buf1 = torch.empty_like(x)
        fed = ctypes.c_int()
        err = getattr(lib, f"{name}_launch")(
            x.data_ptr(), buf0.data_ptr(), buf1.data_ptr(),
            stencil_args(spec, shape), g, DTYPES[x.dtype], grid, lanes,
            lay.smem, _build.stream(), ctypes.byref(fed))
    _build.check(err, f"{name}_launch")
    passes = -(-steps // t)
    return (buf0 if (passes - 1) % 2 == 0 else buf1), bool(fed.value)


def stencil_perks(
    x: torch.Tensor,
    spec: StencilSpec,
    *,
    steps: int,
    cached_rows: int,
    sub_rows: int = 128,
    fuse_steps: int = 1,
) -> torch.Tensor:
    """Run ``steps`` time steps of ``spec`` with rows [0, cached_rows) kept
    on chip for the kernel's whole lifetime (the PERKS scheme); ``x`` is
    not written. ``x`` is one domain, or ``[B, ...]``: B domains in one
    launch, each lane bit-equal to its own run.

    ``fuse_steps=t`` is temporal blocking: the streamed rows go through
    device memory once every t steps (the last pass takes ``steps % t``),
    in tiles that recompute an r*t halo (``csrc/stencil_shallow.cu``); t
    is ``min(fuse_steps, steps)``, and t = 1 runs ``csrc/stencil_perks.cu``
    (``perks_layout``; a layout that does not fit raises ``ValueError``),
    or with every row cached ``csrc/stencil_resident.cu`` where it holds
    the domain (counted as ``stencil_resident``'s launch).
    ``sub_rows`` is the reference's streaming tile, checked as the
    reference checks it; the CUDA kernels choose their own tiles
    (``tb_layout``).
    """
    _check_perks_args(x, spec, steps, cached_rows, sub_rows, fuse_steps)
    if _build.is_cpu(x, "stencil"):
        return ref.stencil_run(x, spec, steps)
    _check_cuda(x, spec, batched=True)
    if steps == 0:
        return x.clone()
    shape, lanes = _lanes(x, spec)
    batched = x.dim() > spec.ndim
    t = min(fuse_steps, steps)
    if t > 1:
        out, copied = _launch_tb(x, spec, steps, t, cached_rows, deep=False)
        stencil_perks.fused_launches += 1
        stencil_perks.fused_batched_launches += batched
        stencil_perks.fused_async_launches += copied
        return out
    if cached_rows == shape[0] and _resident_holds(x, spec, lanes):
        out, copied = _launch_resident(x, spec, steps)
        stencil_resident.launches += 1
        stencil_resident.batched_launches += batched
        stencil_resident.async_launches += copied
        return out
    out, fed = _launch_perks(x, spec, steps, cached_rows)
    stencil_perks.launches += 1
    stencil_perks.batched_launches += batched
    stencil_perks.window_launches += fed
    return out


def _resident_holds(x: torch.Tensor, spec: StencilSpec, lanes: int) -> bool:
    """Whether ``csrc/stencil_resident.cu`` holds the whole domain (each of
    ``lanes`` domains on its lane's CTAs) on the card; else the one-step
    kernel's boxes take every plane."""
    lib = _build.load("stencil_resident")
    with _build.on_device(x):
        limit = _limit(lib, "stencil_resident", spec, x)
        full = _co_resident("stencil_resident", spec.npoints,
                            DTYPES[x.dtype], limit, x.device.index)
        ctas = lane_ctas(full, lanes)
        return ctas > 0 and resident_layout(
            _lanes(x, spec)[0], spec.radius, x.element_size(), ctas,
            limit) is not None


stencil_perks.launches = 0
#: the launches of a batch ([B, ...]) of domains, one-step and fused
stencil_perks.batched_launches = 0
#: the one-step launches whose window rows were bulk copies (the
#: others load them through L2)
stencil_perks.window_launches = 0
stencil_perks.fused_launches = 0
stencil_perks.fused_batched_launches = 0
#: the fused launches whose tile windows were copied by cp.async (the
#: others load through L2)
stencil_perks.fused_async_launches = 0


def stencil_perks_deep(
    x: torch.Tensor,
    spec: StencilSpec,
    *,
    steps: int,
    cached_rows: int,
    sub_rows: int = 128,
    fuse_steps: int = 1,
) -> torch.Tensor:
    """Deep temporal blocking: t = ``min(fuse_steps, steps)`` steps a pass
    with no recompute along the rows — every streamed row is read and
    written once a pass, the strips' side halos are the only redundant
    work (``csrc/stencil_tb.cu``, the deep schedule). Rows [0, cached_rows)
    stay on chip as in ``stencil_perks``; ``x`` is not written.

    The reference's preconditions raise ``ValueError``: ``sub_rows`` (its
    wavefront block, which the CUDA kernel does not use) must be at least
    the radius. A layout the CTA's shared memory cannot hold raises
    ``ValueError`` naming the limit. ``x`` may be ``[B, ...]``, as in
    ``stencil_perks``.
    """
    _check_perks_args(x, spec, steps, cached_rows, sub_rows, fuse_steps,
                      deep=True)
    if _build.is_cpu(x, "stencil"):
        return ref.stencil_run(x, spec, steps)
    _check_cuda(x, spec, batched=True)
    H = _lanes(x, spec)[0][0]
    if H >= DEEP_MAX_ROWS:
        raise ValueError(f"the deep schedule takes fewer than "
                         f"{DEEP_MAX_ROWS} rows, got {H}")
    if steps == 0:
        return x.clone()
    t = max(1, min(fuse_steps, steps))
    out, tma = _launch_tb(x, spec, steps, t, cached_rows, deep=True)
    stencil_perks_deep.launches += 1
    stencil_perks_deep.batched_launches += x.dim() > spec.ndim
    stencil_perks_deep.tma_launches += tma
    return out


stencil_perks_deep.launches = 0
stencil_perks_deep.batched_launches = 0
#: the launches that loaded level 0 by TMA (the others load through L2)
stencil_perks_deep.tma_launches = 0


def stencil_resident(
    x: torch.Tensor,
    spec: StencilSpec,
    *,
    steps: int,
) -> torch.Tensor:
    """Small-domain PERKS: the whole domain stays in the co-resident CTAs'
    shared memory for all steps — device memory sees one load and one
    store, apart from the bands' r-row borders each step
    (``csrc/stencil_resident.cu``). Raises ``ValueError`` if it does not
    fit (``resident_layout``); never streams. ``x`` may be ``[B, ...]``,
    each lane on its share of the CTAs (``lane_ctas``)."""
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if _build.is_cpu(x, "stencil"):
        return ref.stencil_run(x, spec, steps)
    _check_cuda(x, spec, batched=True)
    if steps == 0:
        return x.clone()
    out, copied = _launch_resident(x, spec, steps)
    stencil_resident.launches += 1
    stencil_resident.batched_launches += x.dim() > spec.ndim
    stencil_resident.async_launches += copied
    return out


stencil_resident.launches = 0
stencil_resident.batched_launches = 0
#: the launches whose halo rows were copied by cp.async (halo rows in
#: shared memory and 16-byte aligned rows; the others load them through L2
#: or read them from device memory)
stencil_resident.async_launches = 0


def stencil_baseline_step(
    x: torch.Tensor,
    spec: StencilSpec,
    *,
    sub_rows: int = 128,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One non-persistent time step (the host-loop baseline's kernel),
    written into ``out`` when given (it must not alias ``x``). ``x`` is one
    domain, or ``[B, ...]``: B domains of ``spec``'s rank stepped in ONE
    launch (the batched tier), each bit-equal to its own launch.
    ``sub_rows`` is accepted for the reference's signature and not used."""
    batched = x.dim() == spec.ndim + 1
    if _build.is_cpu(x, "stencil"):
        return ref.stencil_step(x, spec, out=out)
    dom = x[0] if batched else x
    _check_cuda(dom, spec)
    if not x.is_contiguous():
        raise ValueError("the CUDA stencil kernels take contiguous tensors")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype
          or out.device != x.device or not out.is_contiguous()
          or out.data_ptr() == x.data_ptr()):
        raise ValueError("out must be a contiguous tensor like x, apart "
                         "from x")
    lib = _build.load("stencil_step")
    batch = x.shape[0] if batched else 1
    with _build.on_device(x):
        shape, sms = tuple(dom.shape), _sm_count(x.device.index)
        lay = step_layout(spec, shape, x.element_size(), batch, sms)
        lay = step_layout(spec, shape, x.element_size(), batch, sms,
                          per_sm=_step_per_sm(spec, shape, DTYPES[x.dtype],
                                              lay.threads, lay.smem,
                                              x.device.index))
        aligned = (lay.row_aligned and x.data_ptr() % 16 == 0
                   and out.data_ptr() % 16 == 0)
        gx, gy, _ = lay.grid
        matched = ctypes.c_int()
        err = lib.stencil_step_launch(x.data_ptr(), out.data_ptr(),
                                      stencil_args(spec, shape),
                                      lay.c_args[aligned], DTYPES[x.dtype],
                                      batch, gx, gy, lay.smem,
                                      _build.stream(), ctypes.byref(matched))
    _build.check(err, "stencil_step_launch")
    stencil_baseline_step.launches += 1
    stencil_baseline_step.batched_launches += batched
    stencil_baseline_step.unaligned_launches += not aligned
    stencil_baseline_step.runtime_launches += matched.value < 0
    return out


stencil_baseline_step.launches = 0
#: the launches that stepped a batch ([B, ...]) of domains
stencil_baseline_step.batched_launches = 0
#: the launches whose rows (or tensors) are not on 16-byte boundaries: the
#: kernel copies and stores them cell by cell
stencil_baseline_step.unaligned_launches = 0
#: the launches of a spec that is none of the kernel's compiled shapes (the
#: Table-III specs): offsets read at run time
stencil_baseline_step.runtime_launches = 0
