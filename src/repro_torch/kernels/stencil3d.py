"""3D PERKS stencils (3d7pt/3d13pt/3d17pt/3d27pt/poisson): the port of
``repro/kernels/stencil3d.py``.

The kernels in ``stencil2d.py`` block along the leading axis, so 3D reuses
them with z-planes as rows. The one 3D-specific piece is how many leading
planes can stay on chip, re-derived here for Hopper.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.hardware import Chip, device_chip
from repro_torch.kernels.common import StencilSpec
from repro_torch.kernels.stencil2d import (PERKS_STATIC_SMEM, band_smem_bytes,
                                           rows_per_cta)
# rank-generic kernels, re-exported so they stay importable from the 3D module
from repro_torch.kernels.stencil2d import (  # noqa: F401
    stencil_baseline_step,
    stencil_perks,
    stencil_resident,
)

__all__ = [
    "stencil_perks",
    "stencil_resident",
    "stencil_baseline_step",
    "plan_resident_planes",
]


def plan_resident_planes(
    shape: tuple[int, ...],
    dtype_bytes: int,
    spec: StencilSpec,
    *,
    chip: Optional[Chip] = None,
) -> int:
    """How many leading planes (rows in 2D) the persistent kernel can keep
    in shared memory: one CTA per SM, each holding a band of rows next to
    its ``radius``-row ring, in the per-block shared memory less the
    kernel's static buffers. A row counts only where the kernel can hold
    it: rows wider than its registers take, or a layout that would not fit,
    give 0. Returns a count in [0, shape[0]].

    ``chip`` defaults to the card's own SM count and shared memory, or the
    H100 data sheet when planning without a card.
    """
    chip = device_chip() if chip is None else chip
    r = spec.radius
    row_cells = math.prod(shape[1:])
    row_bytes = row_cells * dtype_bytes
    smem = chip.smem_per_block - PERKS_STATIC_SMEM
    planes = min(shape[0], chip.sms * rows_per_cta(row_cells, dtype_bytes,
                                                    r, smem))
    if planes < min(r, shape[0]):
        return 0
    if band_smem_bytes(planes, r, row_bytes, chip.sms) > smem:
        return 0
    return planes
