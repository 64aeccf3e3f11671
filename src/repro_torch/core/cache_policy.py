"""The PERKS caching policy (paper §III-B): the stencil part of
``repro/core/cache_policy.py``, copied so the port imports nothing of the
reference.

Regions of a stencil shard, by what caching them saves per step:

  1. data with no inter-block dependency (the interior): one load and one
     store;
  2. data read by neighbours (the boundary): one load — the store must
     still reach device memory;
  3. halo data owned by neighbours: nothing; never cached.
"""
from __future__ import annotations

import dataclasses


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
