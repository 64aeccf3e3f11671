"""3D PERKS stencils (3d7pt/3d13pt/3d17pt/3d27pt/poisson): the port of
``repro/kernels/stencil3d.py``.

The kernels in ``stencil2d.py`` block along the leading axis, so 3D reuses
them with z-planes as rows (the temporal-blocking kernels and the one-step
kernel's streamed rows tile each plane into rectangles; the one-step
kernel cuts cached planes wider than a CTA's registers hold into boxes of
plane rows). The one 3D-specific piece is how many leading planes can stay
on chip, re-derived here for Hopper. The persistent entry points take a
batch of domains ``[B, ...]`` as they do in 2D (``stencil2d.lane_ctas``);
``plan_resident_planes`` with ``chip=exec.batch.per_instance_chip(chip,
B)`` gives the planes one lane holds.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.hardware import Chip, device_chip
from repro_torch.kernels.common import StencilSpec
from repro_torch.kernels.stencil2d import (PERKS_STATIC_SMEM,
                                           perks_cached_rows, perks_layout,
                                           resident_layout, tb_cached_rows)
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

    ``fuse_steps=1``, shallow: every plane where ``csrc/stencil_resident.cu``
    (``resident_layout``) or the boxes of ``csrc/stencil_perks.cu``
    (``perks_layout``, nothing streamed) hold the domain; else
    ``stencil2d.perks_cached_rows``: the one-step kernel's boxes (bands of
    planes, cut into slabs of plane rows where a plane is wider than a
    CTA's registers hold), each with the ``radius`` planes it shifts by,
    beside the streamed rows' window. Otherwise (``csrc/stencil_shallow.cu`` or
    ``csrc/stencil_tb.cu``, t = ``fuse_steps`` steps a pass): the band, its
    2*r*t halo rows and the ring take at most half of the CTA, the
    streaming scratch (tiles or strip rings, ``stencil2d.tb_layout``) the
    rest; 0 when no band fits beside it or the kernel cannot run t steps a
    pass at all (rows wider than its registers take give 0).

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
    shape = tuple(shape)
    H = shape[0]
    if (resident_layout(shape, r, dtype_bytes, chip.sms, smem) is not None
            or perks_layout(shape, r, dtype_bytes, chip.sms, smem,
                            H) is not None):
        return H
    return perks_cached_rows(shape, r, dtype_bytes, chip.sms, smem)
