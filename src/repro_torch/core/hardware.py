"""Hardware constants for the cache planner and the performance model: the
port's ``repro/core/hardware.py``, with the one card it runs on.

Figures for the H100 SXM5 80 GB come from NVIDIA's H100 Tensor Core GPU
data sheet and the NVIDIA H100 Tensor Core GPU Architecture white paper
(Hopper): 132 SMs, up to 227 KB of shared memory per thread block (of the
SM's 256 KB combined L1/shared memory), 64K 32-bit registers per SM, 50 MB
of L2, 80 GB of HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside the tensor
cores. None of the TPU entries' constants are carried over.
"""
from __future__ import annotations

import dataclasses

GiB = 1024**3
MiB = 1024**2
KiB = 1024


@dataclasses.dataclass(frozen=True)
class Chip:
    """Per-card capabilities relevant to the PERKS model and the roofline."""

    name: str
    #: Peak compute for the kernels' own type, FLOP/s. The stencil kernels
    #: compute in float32 on the CUDA cores, so this is the float32 rate.
    peak_flops: float
    #: Device-memory bandwidth, bytes/s.
    hbm_bw: float
    #: Device-memory capacity, bytes.
    hbm_bytes: float
    #: On-chip bytes the PERKS kernel can cache in: SMs x shared memory per
    #: block (the port's kernel keeps cached rows in shared memory only).
    onchip_bytes: float
    #: Aggregate shared-memory bandwidth, bytes/s.
    onchip_bw: float
    #: Streaming multiprocessors (one persistent CTA each).
    sms: int = 0
    #: Shared memory one CTA may use (opt-in maximum), bytes.
    smem_per_block: int = 0
    #: 32-bit registers per SM.
    regs_per_sm: int = 0
    #: L2 cache, bytes.
    l2_bytes: int = 0


# Shared-memory bandwidth: 128 bytes per clock per SM (Hopper white paper)
# x 132 SMs x 1.98 GHz boost clock of the SXM5 part = 33.5 TB/s.
H100 = Chip(
    name="h100",
    peak_flops=67e12,
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    onchip_bytes=132 * 232448,
    onchip_bw=132 * 128 * 1.98e9,
    sms=132,
    smem_per_block=232448,          # 227 KB
    regs_per_sm=65536,
    l2_bytes=50 * 10**6,
)

CHIPS = {c.name: c for c in (H100,)}


def device_chip(chip: Chip = H100) -> Chip:
    """``chip`` with the SM count and per-block shared memory read from the
    card when one is present; the data-sheet constants otherwise (planning
    on the CPU)."""
    import torch

    if not torch.cuda.is_available():
        return chip
    props = torch.cuda.get_device_properties(0)
    smem = getattr(props, "shared_memory_per_block_optin", chip.smem_per_block)
    return dataclasses.replace(
        chip, sms=props.multi_processor_count, smem_per_block=int(smem),
        onchip_bytes=props.multi_processor_count * int(smem))
