"""The PERKS caching policy (paper §III-B): the stencil, CG, BiCGStab and
GMRES parts of ``repro/core/cache_policy.py``, copied so the port imports
nothing of the reference.

Regions of a stencil shard, by what caching them saves per step:

  1. data with no inter-block dependency (the interior): one load and one
     store;
  2. data read by neighbours (the boundary): one load — the store must
     still reach device memory;
  3. halo data owned by neighbours: nothing; never cached.

For multi-array solvers (CG) arrays are ranked by traffic saved per byte
cached: the residual r (3 loads + 1 store per element per iteration)
outranks the matrix A (1 load). ``plan_caching`` is the reference's greedy
fractional knapsack on that density (the paper's §VI-G3: "a simple greedy
approach ... gives mostly the best performance").
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class CacheableArray:
    """One array (or domain region) a solver touches each time step.

    loads/stores are *device-memory accesses per byte per time step* in
    the non-cached execution. ``inter_block_dep`` marks boundary data whose
    stores cannot be elided; ``is_halo`` marks neighbour-owned data that is
    refreshed every step.
    """

    name: str
    bytes: int
    loads_per_step: float = 1.0
    stores_per_step: float = 1.0
    inter_block_dep: bool = False
    is_halo: bool = False

    def traffic_saved_per_byte(self) -> float:
        """Device-memory bytes avoided per cached byte per time step."""
        if self.is_halo:
            return 0.0
        if self.inter_block_dep:
            return self.loads_per_step
        return self.loads_per_step + self.stores_per_step


@dataclasses.dataclass(frozen=True)
class CacheAssignment:
    array: CacheableArray
    cached_bytes: int

    @property
    def fraction(self) -> float:
        return self.cached_bytes / self.array.bytes if self.array.bytes else 0.0


@dataclasses.dataclass(frozen=True)
class CachePlan:
    assignments: tuple[CacheAssignment, ...]
    budget_bytes: int

    @property
    def cached_bytes(self) -> int:
        return sum(a.cached_bytes for a in self.assignments)

    @property
    def traffic_saved_per_step(self) -> float:
        """Total device-memory bytes avoided per time step under this plan."""
        return sum(
            a.cached_bytes * a.array.traffic_saved_per_byte()
            for a in self.assignments
        )

    def fraction_of(self, name: str) -> float:
        for a in self.assignments:
            if a.array.name == name:
                return a.fraction
        return 0.0


def plan_caching(
    arrays: Sequence[CacheableArray],
    budget_bytes: int,
    *,
    reserve_bytes: int = 0,
) -> CachePlan:
    """Greedy fractional-knapsack cache plan (the paper's policy).

    ``reserve_bytes`` holds back on-chip memory the kernel itself needs.
    Arrays are divisible (any prefix can be cached), so the greedy order by
    traffic saved per byte is optimal; ties keep the caller's order.
    """
    budget = max(0, budget_bytes - reserve_bytes)
    ranked = [
        a
        for _, _, a in sorted(
            (-a.traffic_saved_per_byte(), i, a)
            for i, a in enumerate(arrays)
            if a.traffic_saved_per_byte() > 0.0
        )
    ]
    assignments = []
    remaining = budget
    for arr in ranked:
        take = min(arr.bytes, remaining)
        if take <= 0:
            break
        assignments.append(CacheAssignment(arr, take))
        remaining -= take
    return CachePlan(tuple(assignments), budget)


def stencil_arrays(
    interior_bytes: int,
    boundary_bytes: int,
    halo_bytes: int,
) -> list[CacheableArray]:
    """Cacheable regions of a stencil shard, per paper §III-B1."""
    return [
        CacheableArray("interior", interior_bytes, 1.0, 1.0, inter_block_dep=False),
        CacheableArray("boundary", boundary_bytes, 1.0, 1.0, inter_block_dep=True),
        CacheableArray("halo", halo_bytes, 1.0, 0.0, is_halo=True),
    ]


def stencil_shard_arrays(
    shard_rows: int,
    row_bytes: int,
    radius: int,
    *,
    fuse_steps: int = 1,
) -> list[CacheableArray]:
    """Cacheable regions of a row-partitioned shard under temporal
    blocking: with ``fuse_steps`` = t the boundary ring and the halo widen
    from ``radius`` to ``radius * t`` rows per side."""
    ring = min(shard_rows, 2 * radius * fuse_steps)   # both sides
    interior = shard_rows - ring
    return stencil_arrays(interior * row_bytes, ring * row_bytes,
                          2 * radius * fuse_steps * row_bytes)


def gm_bytes_fused(
    n_steps: int,
    domain_bytes: int,
    cached_bytes: int,
    *,
    row_bytes: int,
    radius: int,
    fuse_steps: int,
) -> float:
    """Eq. 5 generalized to temporal blocking:

        A_gm = ceil(N/t) * (2*D_uncached + 2*r*t*row_bytes) + 2*D_cached

    ``fuse_steps=1`` is Eq. 5 plus the per-step halo re-read of Eq. 9.
    """
    t = fuse_steps
    passes = -(-n_steps // t)
    uncached = max(0, domain_bytes - cached_bytes)
    overlap = 2 * radius * t * row_bytes if uncached else 0
    return passes * (2.0 * uncached + overlap) + 2.0 * cached_bytes


def gm_bytes_deep(
    n_steps: int,
    domain_bytes: int,
    cached_bytes: int,
    *,
    fuse_steps: int,
) -> float:
    """Eq. 5 under deep temporal blocking (the wavefront schedule of
    ``stencil_perks_deep``): each pass reads and writes every uncached row
    exactly once, whatever t,

        A_gm = ceil(N/t) * 2*D_uncached + 2*D_cached

    the least traffic of t fused steps a pass (the reference's model; the
    port's kernel also re-reads halos, ``gm_bytes_tb``)."""
    t = fuse_steps
    passes = -(-n_steps // t)
    uncached = max(0, domain_bytes - cached_bytes)
    return passes * 2.0 * uncached + 2.0 * cached_bytes


def deep_scratch_rows(sub_rows: int, radius: int, fuse_steps: int) -> int:
    """The reference's on-chip working set of its deep kernel beyond the
    resident rows, in rows: (2t+3) block buffers and (t+1) radius-row edge
    stashes. The port's planner gates on its own kernel's layout
    (``kernels.stencil2d.tb_layout``); this stays for parity."""
    return (2 * fuse_steps + 3) * sub_rows + (fuse_steps + 1) * radius


def _window_sum(n: int, size: int, halo: int, width: int = 0) -> int:
    """Sum over the ``size``-wide pieces [lo, hi) of [0, n) of their
    windows [lo - halo, hi + halo), or [lo - halo, lo - halo + width) when
    ``width`` is given, clamped to [0, n)."""
    span = width or size + 2 * halo
    return sum(min(n, lo - halo + span) - max(0, lo - halo)
               for lo in range(0, n, size))


def deep_window(strip_cols: int, radius: int, t: int, dtype_bytes: int,
                ndim: int) -> tuple[int, int]:
    """``(left, width)``: the columns [x0 - left, x0 - left + width) of the
    deep schedule's level 0 for a strip of ``strip_cols`` columns from x0
    (a multiple of 16 bytes). A TMA box starts only on a 16-byte column,
    so the r*t halo on the left is rounded up to 16 bytes; the width
    covers r*t on the right too and is whole boxes, 128 bytes in 2D and
    16 in 3D."""
    align = 16 // dtype_bytes
    left = -(-radius * t // align) * align
    box = (128 if ndim == 2 else 16) // dtype_bytes
    return left, -(-(left + strip_cols + radius * t) // box) * box


def gm_bytes_tb(
    n_steps: int,
    shape: tuple[int, ...],
    dtype_bytes: int,
    *,
    radius: int,
    fuse_steps: int,
    cached_rows: int,
    bands: int,
    strip: tuple[int, int],
    rows: int,
    deep: bool,
) -> float:
    """Device-memory bytes of the port's temporal-blocking kernels
    (``csrc/stencil_shallow.cu``, ``csrc/stencil_tb.cu``) for ``n_steps``
    steps, t = ``fuse_steps`` a pass (a last pass of ``n_steps % t``):

    * the cached rows [0, R), cut into ``bands`` bands: one load and one
      store in all, plus each pass every band's r*ct halo rows read and its
      top and bottom r*t rows written;
    * shallow: every ``rows`` x ``strip`` tile of the streamed rows read
      with an r*ct halo on every side (clamped at the domain border) and
      its interior written, once a pass;
    * deep: every strip x segment of ``rows`` streamed rows read with
      r*ct warm-up rows above and below it over level 0's window
      (``deep_window``; clamped at the domain border), and the streamed
      rows written, once a pass.

    ``strip`` is (plane rows, columns); plane rows are 1 in 2D. Never below
    ``gm_bytes_deep`` at the same cached rows."""
    H, R, r, t = shape[0], cached_rows, radius, fuse_steps
    D1 = shape[1] if len(shape) == 3 else 1
    D2 = shape[-1]
    row_bytes = D1 * D2 * dtype_bytes
    sy, sx = strip
    total = 2.0 * R * row_bytes
    full, rem = divmod(n_steps, t)
    for passes, ct in ((full, t), (1, rem)):
        if passes == 0 or ct == 0:
            continue
        h = r * ct
        per = 0
        for b in range(bands):
            b0, b1 = b * R // bands, (b + 1) * R // bands
            per += (b0 - max(0, b0 - h)) + (min(H, b1 + h) - b1)
            top = min(b0 + r * t, b1)
            per += (top - b0) + (b1 - max(b1 - r * t, top))
        per *= row_bytes
        if R < H:
            if deep:
                left, width = deep_window(sx, r, t, dtype_bytes, len(shape))
                plane = (_window_sum(D1, sy, r * t if len(shape) == 3 else 0)
                         * _window_sum(D2, sx, left, width))
            else:
                plane = (_window_sum(D1, sy, h if len(shape) == 3 else 0)
                         * _window_sum(D2, sx, h))
            per += sum(min(H, lo + rows + h) - max(0, lo - h)
                       for lo in range(R, H, rows)) * plane * dtype_bytes
            per += (H - R) * D1 * D2 * dtype_bytes
        total += passes * per
    return total


def gm_bytes_perks(
    n_steps: int,
    shape: tuple[int, ...],
    dtype_bytes: int,
    *,
    radius: int,
    cached_rows: int,
    boxes: tuple[int, int],
    strip: tuple[int, int],
    left: int,
    strips: int,
) -> float:
    """Device-memory bytes of the port's one-step kernel
    (``csrc/stencil_perks.cu``) for ``n_steps`` steps: Eq. 5 plus the
    per-step halo re-read, for its boxes and windows:

    * the cached planes [0, R), cut into ``boxes`` = (bands, slabs of plane
      rows): one load (each box with its r halo plane rows on a cut side)
      and one store in all, plus each step every box's halo plane rows
      read and its r-deep faces written (its first and last r planes and,
      cut into slabs, its first and last r plane rows of the planes
      between);
    * each step, every one of ``strips`` strips of the streamed rows [R, H)
      read with r rows above and below it (clamped at the domain border)
      over each tile's window (``strip`` = (plane rows, columns) widened by
      r plane rows in 3D, its columns from ``left`` before the tile to r
      after it, the end rounded up to 16 bytes, clamped to the domain),
      and the streamed rows written once."""
    H, R, r = shape[0], cached_rows, radius
    is3 = len(shape) == 3
    D1 = shape[1] if is3 else 1
    D2 = shape[-1]
    nbz, nby = boxes
    once = 0
    per = 0
    for bz in range(nbz):
        b0, b1 = bz * R // nbz, (bz + 1) * R // nbz
        top = min(b0 + r, b1)
        bot = max(b1 - r, top)
        for by in range(nby):
            y0, y1 = by * D1 // nby, (by + 1) * D1 // nby
            stored = min(D1, y1 + r) - max(0, y0 - r) if nby > 1 else D1
            once += (b1 - b0) * (stored + (y1 - y0))
            per += (b1 - b0) * (stored - (y1 - y0))
            per += ((top - b0) + (b1 - bot)) * (y1 - y0)
            if nby > 1:
                cut = (r if y0 > 0 else 0) + (r if y1 < D1 else 0)
                per += (bot - top) * min(cut, y1 - y0)
    per *= D2
    if R < H:
        sy, sx = strip
        align = 16 // dtype_bytes
        cols = sum(min(D2, -(-min(D2, x0 + sx + r) // align) * align)
                   - max(0, x0 - left) for x0 in range(0, D2, sx))
        plane = _window_sum(D1, sy, r if is3 else 0) * cols
        rows = sum(min(H, R + (g + 1) * (H - R) // strips + r)
                   - max(0, R + g * (H - R) // strips - r)
                   for g in range(strips))
        per += rows * plane + (H - R) * D1 * D2
    return (once * D2 + n_steps * per) * float(dtype_bytes)


def cg_arrays(n_rows: int, nnz: int, dtype_bytes: int,
              index_bytes: int = 4) -> list[CacheableArray]:
    """Cacheable arrays of the PERKS conjugate-gradient solver (§III-B2).

    Per CG iteration the residual r is read by the dot products and the
    axpy updates (3 loads) and written once; p, x and Ap alike; the matrix
    A is read once and never written. All are listed so the planner can
    fill the remaining budget with A the way Fig. 9's MIX does.
    """
    vec = n_rows * dtype_bytes
    return [
        CacheableArray("r", vec, 3.0, 1.0),
        CacheableArray("p", vec, 3.0, 1.0),
        CacheableArray("x", vec, 1.0, 1.0),
        CacheableArray("Ap", vec, 2.0, 1.0),
        CacheableArray("A", nnz * (dtype_bytes + index_bytes), 1.0, 0.0),
    ]


def cg_arrays_for(matrix) -> list[CacheableArray]:
    """``cg_arrays`` from a sparse container (COO/CSR/ELL/SELL, of either
    package), duck-typed on ``shape``/``nnz``/``data.dtype``. Uses the
    container's **true** nnz: for padded formats the planner must rank A by
    the bytes it really streams, not the zero-filled slots."""
    return cg_arrays(matrix.shape[0], matrix.nnz, matrix.data.dtype.itemsize)


def bicgstab_arrays(n_rows: int, nnz: int, dtype_bytes: int,
                    index_bytes: int = 4) -> list[CacheableArray]:
    """Cacheable arrays of one BiCGStab iteration.

    Seven working vectors instead of CG's four, and the matrix streams
    TWICE per iteration (v = A p, then t = A s), which doubles A's traffic
    density relative to CG. Per iteration (``kernels.ref.
    bicgstab_iteration_matvec``): r feeds the rho dot, the p update and the
    s axpy (3 loads, 1 store); s feeds t = A s, two stabilization dots and
    the x/r updates (3/1); p is rebuilt and consumed by the SpMV and the x
    update (3/1); rhat is read by two dots and never written; v and t are
    produced once and read twice; x accumulates.
    """
    vec = n_rows * dtype_bytes
    return [
        CacheableArray("r", vec, 3.0, 1.0),
        CacheableArray("s", vec, 3.0, 1.0),
        CacheableArray("p", vec, 3.0, 1.0),
        CacheableArray("v", vec, 2.0, 1.0),
        CacheableArray("t", vec, 2.0, 1.0),
        CacheableArray("rhat", vec, 2.0, 0.0),
        CacheableArray("x", vec, 1.0, 1.0),
        CacheableArray("A", nnz * (dtype_bytes + index_bytes), 2.0, 0.0),
    ]


def bicgstab_arrays_for(matrix) -> list[CacheableArray]:
    """``bicgstab_arrays`` from a sparse container (true nnz)."""
    return bicgstab_arrays(matrix.shape[0], matrix.nnz,
                           matrix.data.dtype.itemsize)


def gmres_arrays(n_rows: int, m: int, nnz: int, dtype_bytes: int,
                 index_bytes: int = 4) -> list[CacheableArray]:
    """Cacheable arrays of one GMRES(m) cycle, normalised per inner
    Arnoldi step.

    The basis V, (m+1) vectors, is read twice by every inner step (the two
    CGS2 projections) and extended once: keeping it on chip is the PERKS
    case for GMRES, a cycle that never moves the basis through device
    memory. A streams once per inner SpMV; w (the candidate vector) is
    built, projected twice and normalised; x and r move only at cycle
    boundaries (1/m per inner step, rounded to the planner's coarse 1.0).
    """
    vec = n_rows * dtype_bytes
    return [
        CacheableArray("V", (m + 1) * vec, 2.0, 1.0),
        CacheableArray("w", vec, 3.0, 1.0),
        CacheableArray("r", vec, 1.0, 1.0),
        CacheableArray("x", vec, 1.0, 1.0),
        CacheableArray("A", nnz * (dtype_bytes + index_bytes), 1.0, 0.0),
    ]


def gmres_arrays_for(matrix, m: int) -> list[CacheableArray]:
    """``gmres_arrays`` from a sparse container (true nnz)."""
    return gmres_arrays(matrix.shape[0], m, matrix.nnz,
                        matrix.data.dtype.itemsize)
