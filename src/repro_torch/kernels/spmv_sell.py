"""SELL-C-σ SpMV on Hopper: the port of ``repro/kernels/spmv_sell.py``.

``spmv_sell(data, cols, slice_offsets, slice_k, x, c=, k_max=)`` computes
y_perm = A_perm @ x for A in SELL-C-σ layout (``repro_torch.sparse.
SellMatrix``: flat slot-major float32 ``data`` and int32 ``cols``, int32
``slice_offsets``/``slice_k`` of length n_slices). The result is in the
permuted, padded row order, (n_slices * c,), as the reference returns it;
``solvers.cg.SellOperator.matvec`` gathers it back to row order.

A CPU tensor runs the plain torch version (``ref.spmv_sell``); a CUDA
tensor launches ``csrc/spmv_sell.cu`` or raises — there is no fallback.
The kernel reads each slice's own width from ``slice_k``, so ``k_max``
bounds only the plain version's slot loop (it must be at least every
``slice_k``, as for the reference). The wrapper counts its launches in
``launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.spmv_ell import check_vector


def _check(data, cols, slice_offsets, slice_k, x, c: int) -> None:
    if c < 1:
        raise ValueError(f"c must be >= 1, got {c}")
    if data.dim() != 1 or cols.shape != data.shape:
        raise ValueError("spmv_sell: data and cols must be flat streams of "
                         f"one length, got {tuple(data.shape)} and "
                         f"{tuple(cols.shape)}")
    if slice_offsets.dim() != 1 or slice_k.shape != slice_offsets.shape:
        raise ValueError("spmv_sell: slice_offsets and slice_k must be "
                         "(n_slices,) alike")
    check_vector(x, data, "spmv_sell")
    if data.device.type != "cuda":
        return
    if data.dtype != torch.float32 or cols.dtype != torch.int32:
        raise TypeError("spmv_sell: the CUDA kernel takes float32 data and "
                        f"int32 cols, got {data.dtype} and {cols.dtype}")
    if slice_offsets.dtype != torch.int32 or slice_k.dtype != torch.int32:
        raise TypeError("spmv_sell: the CUDA kernel takes int32 slice "
                        "tables")
    for t in (data, cols, slice_offsets, slice_k):
        if t.device != data.device or not t.is_contiguous():
            raise ValueError("spmv_sell: every operand must be contiguous "
                             f"on {data.device}")
    if data.numel() >= 2**31 or slice_offsets.numel() * c >= 2**31:
        raise ValueError("spmv_sell: the operator exceeds 32-bit indexing")


def spmv_sell(
    data: torch.Tensor,
    cols: torch.Tensor,
    slice_offsets: torch.Tensor,
    slice_k: torch.Tensor,
    x: torch.Tensor,
    *,
    c: int,
    k_max: int,
) -> torch.Tensor:
    """y_perm = A_perm @ x in the permuted padded order (n_slices * c,)."""
    _check(data, cols, slice_offsets, slice_k, x, c)
    if _build.is_cpu(data, "spmv_sell"):
        if slice_k.numel() and int(slice_k.max()) > k_max:
            raise ValueError(f"k_max={k_max} is below the widest slice "
                             f"({int(slice_k.max())} slots)")
        return ref.spmv_sell(data, cols, slice_offsets, slice_k, x, c=c,
                             k_max=k_max)
    n_slices = slice_offsets.shape[0]
    y = torch.empty(n_slices * c, dtype=x.dtype, device=x.device)
    lib = _build.load("spmv_sell")
    with _build.on_device(data):
        err = lib.spmv_sell_launch(
            data.data_ptr(), cols.data_ptr(), slice_offsets.data_ptr(),
            slice_k.data_ptr(), x.data_ptr(), y.data_ptr(), n_slices, c,
            _build.stream())
    _build.check(err, "spmv_sell_launch")
    spmv_sell.launches += 1
    return y


spmv_sell.launches = 0
