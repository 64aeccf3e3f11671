"""Public keyword wrappers for the port's kernels, as in
``repro/kernels/ops.py``: the stencils (temporal blocking included), the
ELL and SELL-C-σ SpMVs, the fused conjugate gradient, BiCGStab, the
GMRES(m) cycle, the Mamba2 SSD scan and flash-decode attention.

Each call dispatches on the tensor's device: a CUDA tensor launches the
hand-written kernel or raises, a CPU tensor runs the plain torch version. ``launch_counts``/``reset_launch_counts`` read and
zero the kernels' launch counters.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cg_fused as _cg
from repro_torch.kernels import decode_attn as _da
from repro_torch.kernels import krylov_fused as _kry
from repro_torch.kernels import spmv_ell as _spmv
from repro_torch.kernels import spmv_sell as _sell
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import stencil2d as _s2d
from repro_torch.kernels import vdot as _vdot
from repro_torch.kernels.common import StencilSpec

#: kernel name -> (the wrapper that carries its launch counter, the
#: counter's attribute): ``stencil_perks`` counts its one-step launches
#: whose window rows came by bulk copies apart, and its ``fuse_steps>1``
#: launches (``csrc/stencil_shallow.cu``) apart, as ``stencil_perks_fused``,
#: and of those the ones whose tiles came by cp.async; ``stencil_perks_deep``
#: counts all its launches, and those that loaded level 0 by TMA apart;
#: ``stencil_resident`` those whose halo rows came by cp.async apart;
#: ``decode_attention`` counts all its launches, and its tensor-core and
#: CUDA-core kernels' apart; ``stencil_baseline_step``, ``spmv_ell`` and
#: ``cg_fused`` count their batched launches (B instances a launch) apart
#: too, as ``<name>_batched``, and so do the persistent stencil kernels, by
#: source: ``stencil_perks_batched`` (``csrc/stencil_perks.cu``),
#: ``stencil_shallow_batched``, ``stencil_resident_batched`` and
#: ``stencil_tb_batched`` (the deep schedule); ``stencil_baseline_step``
#: also its launches on rows not on 16-byte boundaries and of specs it has
#: no compiled shape for
KERNELS = {
    "stencil_perks": (_s2d.stencil_perks, "launches"),
    "stencil_perks_batched": (_s2d.stencil_perks, "batched_launches"),
    "stencil_perks_window": (_s2d.stencil_perks, "window_launches"),
    "stencil_perks_fused": (_s2d.stencil_perks, "fused_launches"),
    "stencil_shallow_batched": (_s2d.stencil_perks, "fused_batched_launches"),
    "stencil_perks_fused_async": (_s2d.stencil_perks, "fused_async_launches"),
    "stencil_perks_deep": (_s2d.stencil_perks_deep, "launches"),
    "stencil_tb_batched": (_s2d.stencil_perks_deep, "batched_launches"),
    "stencil_perks_deep_tma": (_s2d.stencil_perks_deep, "tma_launches"),
    "stencil_resident": (_s2d.stencil_resident, "launches"),
    "stencil_resident_batched": (_s2d.stencil_resident, "batched_launches"),
    "stencil_resident_async": (_s2d.stencil_resident, "async_launches"),
    "stencil_baseline_step": (_s2d.stencil_baseline_step, "launches"),
    "stencil_baseline_step_batched": (_s2d.stencil_baseline_step,
                                      "batched_launches"),
    "stencil_baseline_step_unaligned": (_s2d.stencil_baseline_step,
                                        "unaligned_launches"),
    "stencil_baseline_step_runtime": (_s2d.stencil_baseline_step,
                                      "runtime_launches"),
    "spmv_ell": (_spmv.spmv_ell, "launches"),
    "spmv_ell_batched": (_spmv.spmv_ell, "batched_launches"),
    "spmv_sell": (_sell.spmv_sell, "launches"),
    "cg_fused": (_cg.cg_fused, "launches"),
    "cg_fused_batched": (_cg.cg_fused, "batched_launches"),
    "bicgstab_fused": (_kry.bicgstab_fused, "launches"),
    "gmres_cycle_fused": (_kry.gmres_cycle_fused, "launches"),
    "ssm_scan": (_ssm.ssd_scan, "launches"),
    "ssm_scan_state": (_ssm.ssd_scan, "state_launches"),
    "decode_attention": (_da.decode_attention, "launches"),
    "decode_attention_tc": (_da.decode_attention, "tc_launches"),
    "decode_attention_cc": (_da.decode_attention, "cc_launches"),
    "vdot": (_vdot.vdot, "launches"),
}


def stencil_resident(x: torch.Tensor, *, spec: StencilSpec,
                     steps: int) -> torch.Tensor:
    """Small-domain PERKS stencil (whole domain in shared memory); ``x``
    may be ``[B, ...]``, B domains in one launch, as for the next two."""
    return _s2d.stencil_resident(x, spec, steps=steps)


def stencil_perks(x: torch.Tensor, *, spec: StencilSpec, steps: int,
                  cached_rows: int, sub_rows: int = 128,
                  fuse_steps: int = 1) -> torch.Tensor:
    """Large-domain PERKS stencil (leading rows cached, rest streamed)."""
    return _s2d.stencil_perks(x, spec, steps=steps, cached_rows=cached_rows,
                              sub_rows=sub_rows, fuse_steps=fuse_steps)


def stencil_perks_deep(x: torch.Tensor, *, spec: StencilSpec, steps: int,
                       cached_rows: int, sub_rows: int = 128,
                       fuse_steps: int = 1) -> torch.Tensor:
    """Deep temporal blocking (t steps a pass, no recompute along rows)."""
    return _s2d.stencil_perks_deep(x, spec, steps=steps,
                                   cached_rows=cached_rows,
                                   sub_rows=sub_rows, fuse_steps=fuse_steps)


def stencil_baseline_step(x: torch.Tensor, *, spec: StencilSpec,
                          sub_rows: int = 128,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One non-persistent stencil step (the loop tiers' kernel)."""
    return _s2d.stencil_baseline_step(x, spec, sub_rows=sub_rows, out=out)


def spmv(data: torch.Tensor, cols: torch.Tensor,
         x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV, y = A @ x (the loop tiers' SpMV for ELL planes)."""
    return _spmv.spmv_ell(data, cols, x)


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product of two vectors, or of each lane of two ``[B, n]``
    stacks in one launch, in an order that depends on n only."""
    return _vdot.vdot(a, b)


def spmv_sell(data: torch.Tensor, cols: torch.Tensor,
              slice_offsets: torch.Tensor, slice_k: torch.Tensor,
              x: torch.Tensor, *, c: int, k_max: int) -> torch.Tensor:
    """SELL-C-σ SpMV. Returns the permuted padded result; gather with
    ``SellMatrix.row_positions()`` to restore row order."""
    return _sell.spmv_sell(data, cols, slice_offsets, slice_k, x, c=c,
                           k_max=k_max)


def cg(data: torch.Tensor, cols: torch.Tensor, b: torch.Tensor, *,
       iters: int, resident_matrix: bool = True, block_rows: int = 256,
       matrix_rows: Optional[int] = None
       ) -> tuple[torch.Tensor, torch.Tensor]:
    """PERKS conjugate gradient: the whole iteration loop in one launch;
    ``matrix_rows`` of A (default all, when ``resident_matrix``) stay on
    chip."""
    return _cg.cg_fused(data, cols, b, iters=iters,
                        resident_matrix=resident_matrix,
                        block_rows=block_rows, matrix_rows=matrix_rows)


def bicgstab(data: torch.Tensor, cols: torch.Tensor, b: torch.Tensor, *,
             iters: int, resident_matrix: bool = True, block_rows: int = 256,
             matrix_rows: Optional[int] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """PERKS BiCGStab: the whole iteration loop in one launch (two SpMVs
    per iteration; ``matrix_rows`` of A, default all when
    ``resident_matrix``, on chip, the rest streamed twice per
    iteration)."""
    return _kry.bicgstab_fused(data, cols, b, iters=iters,
                               resident_matrix=resident_matrix,
                               block_rows=block_rows, matrix_rows=matrix_rows)


def gmres_cycle(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                b: torch.Tensor, *, m: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """One GMRES(m) restart cycle with the basis on chip, its small
    least-squares solve included. Returns (V, H, beta, x_new): the
    reference's (V, H, beta), and x + y V[:m]."""
    return _kry.gmres_cycle_fused(data, cols, x, b, m=m)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
             chunk: int = 128, return_state: bool = False):
    """Batched Mamba2 SSD scan with the state on chip: x (B,T,H,P), dt
    (B,T,H), a (H,), b/c (B,T,N), d (H,) -> y (B,T,H,P); with
    ``return_state`` also the final state h (B,H,N,P) float32."""
    return _ssm.ssd_scan(x, dt, a, b, c, d, chunk=chunk,
                         return_state=return_state)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash-decode GQA attention against a KV cache, with optional (B,)
    valid lengths."""
    return _da.decode_attention(q, k, v, length=length)


def launch_counts() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)
