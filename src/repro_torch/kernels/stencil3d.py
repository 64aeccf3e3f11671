"""3D PERKS stencils (3d7pt/3d13pt/3d17pt/3d27pt/poisson): the port of
``repro/kernels/stencil3d.py``.

The kernels in ``stencil2d.py`` block along the leading axis, so 3D reuses
them with z-planes as rows (the temporal-blocking kernel tiles each plane
into rectangles). The one 3D-specific piece is how many leading planes can
stay on chip, re-derived here for Hopper.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.core.hardware import Chip, device_chip
from repro_torch.kernels.common import StencilSpec
from repro_torch.kernels.stencil2d import (PERKS_STATIC_SMEM, band_smem_bytes,
                                           rows_per_cta, tb_cached_rows)
# rank-generic kernels, re-exported so they stay importable from the 3D module
from repro_torch.kernels.stencil2d import (  # noqa: F401
    stencil_baseline_step,
    stencil_perks,
    stencil_perks_deep,
    stencil_resident,
)

__all__ = [
    "stencil_perks",
    "stencil_perks_deep",
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
    fuse_steps: int = 1,
    schedule: str = "shallow",
) -> int:
    """How many leading planes (rows in 2D) the persistent kernels can keep
    in shared memory, counted for ONE CTA (one per SM) in the per-block
    shared memory less the kernels' static buffers. Returns a count in
    [0, shape[0]].

    ``fuse_steps=1``, shallow (``csrc/stencil_perks.cu``; every row:
    ``csrc/stencil_resident.cu``, whose ``resident_layout`` holds exactly
    these): a band of rows next to its ``radius``-row ring. Otherwise
    (``csrc/stencil_shallow.cu`` or ``csrc/stencil_tb.cu``, t =
    ``fuse_steps`` steps a pass): the band, its
    2*r*t halo rows and the ring take at most half of the CTA, the
    streaming scratch (tiles or strip rings, ``stencil2d.tb_layout``) the
    rest; 0 when no band fits beside it or the kernel cannot run t steps a
    pass at all. A row counts only where the kernel can hold it: rows wider
    than its registers take give 0.

    ``chip`` defaults to the card's own SM count and shared memory, or the
    H100 data sheet when planning without a card.
    """
    if schedule not in ("shallow", "deep"):
        raise ValueError(
            f"schedule must be 'shallow' or 'deep', got {schedule!r}")
    chip = device_chip() if chip is None else chip
    r = spec.radius
    smem = chip.smem_per_block - PERKS_STATIC_SMEM
    if fuse_steps > 1 or schedule == "deep":
        rows = tb_cached_rows(tuple(shape), r, fuse_steps, dtype_bytes,
                              deep=schedule == "deep", ctas=chip.sms,
                              limit=smem)
        return rows or 0
    row_cells = math.prod(shape[1:])
    row_bytes = row_cells * dtype_bytes
    planes = min(shape[0], chip.sms * rows_per_cta(row_cells, dtype_bytes,
                                                    r, smem))
    if planes < min(r, shape[0]):
        return 0
    if band_smem_bytes(planes, r, row_bytes, chip.sms) > smem:
        return 0
    return planes
