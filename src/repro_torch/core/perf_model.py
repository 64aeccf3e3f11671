"""The paper's projected-peak model (§IV, Eqs. 4-11): the part of
``repro/core/perf_model.py`` the stencil planner uses.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hardware import Chip


@dataclasses.dataclass(frozen=True)
class PerksProjection:
    """Projected best-case runtime/throughput of a PERKS solver (Eq. 10/11)."""

    t_gm: float          # device-memory time for the domain traffic (Eq. 6)
    t_gm_halo: float     # device-memory time for unavoidable halo traffic (Eq. 9)
    t_sm: float          # on-chip-memory time (Eq. 8)
    t_total: float       # Eq. 10: max(t_gm + t_gm_halo, t_sm)
    cells_per_s: float   # Eq. 11 in cells/s
    bound: str           # "main_memory" | "onchip_memory"


def gm_bytes_accessed(n_steps: int, domain_bytes: int,
                      cached_bytes: int) -> float:
    """Eq. 5: A_gm = 2*N*D_uncache + 2*D_cache."""
    uncached = max(0, domain_bytes - cached_bytes)
    return 2.0 * n_steps * uncached + 2.0 * cached_bytes


def sm_bytes_accessed(n_steps: int, sm_cached_bytes: int) -> float:
    """Eq. 7: A_sm = 2*(N-1)*D_cache_sm (store at step k, load at k+1)."""
    return 2.0 * max(0, n_steps - 1) * sm_cached_bytes


def project_perks(
    chip: Chip,
    *,
    n_steps: int,
    domain_cells: int,
    dtype_bytes: int,
    cached_cells: int,
    halo_bytes_per_step: float = 0.0,
    kernel_sm_bytes_per_step: float = 0.0,
) -> PerksProjection:
    """Paper Eqs. 5-11 for a PERKS solver on ``chip``."""
    d_bytes = domain_cells * dtype_bytes
    c_bytes = cached_cells * dtype_bytes
    a_gm = gm_bytes_accessed(n_steps, d_bytes, c_bytes)
    t_gm = a_gm / chip.hbm_bw
    t_gm_halo = n_steps * halo_bytes_per_step / chip.hbm_bw
    a_sm = sm_bytes_accessed(n_steps, c_bytes) + n_steps * kernel_sm_bytes_per_step
    t_sm = a_sm / chip.onchip_bw
    t_total = max(t_gm + t_gm_halo, t_sm)
    bound = "main_memory" if t_gm + t_gm_halo >= t_sm else "onchip_memory"
    cells_per_s = domain_cells * n_steps / t_total if t_total > 0 else math.inf
    return PerksProjection(t_gm, t_gm_halo, t_sm, t_total, cells_per_s, bound)


def project_host_loop(
    chip: Chip, *, n_steps: int, domain_cells: int, dtype_bytes: int,
) -> PerksProjection:
    """The non-persistent baseline: the full domain is loaded and stored
    from device memory every step (cached_cells = 0)."""
    return project_perks(chip, n_steps=n_steps, domain_cells=domain_cells,
                         dtype_bytes=dtype_bytes, cached_cells=0)
