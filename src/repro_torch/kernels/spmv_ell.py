"""ELL SpMV on Hopper: the port of ``repro/kernels/spmv_ell.py``.

``spmv_ell(data, cols, x)`` computes y = A @ x for A in ELL format
(``data`` float32 and ``cols`` int32, both (n_rows, K), rows padded with
data 0 and column 0), or Y = A X for B right-hand sides x of shape
(B, n_cols) in one launch (the batched CG loop tiers). A CPU tensor runs the plain torch version
(``ref.spmv_ell``); a CUDA tensor launches ``csrc/spmv_ell.cu`` or raises —
there is no fallback. The wrapper counts its launches in ``launches``.

The reference pads the rows to a block multiple for its TPU grid; the CUDA
kernel takes any n, in runs of ``run_rows(K)`` rows that it stages through
shared memory. The host helpers ``dense_to_ell`` and ``poisson2d_ell``
build ELL planes with numpy, as the reference's do.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref


def check_ell(data: torch.Tensor, cols: torch.Tensor, what: str) -> None:
    """The ELL planes' shapes, and on the card their types, contiguity and
    device (shared by the SpMV and the fused CG wrappers)."""
    if data.dim() != 2 or cols.shape != data.shape:
        raise ValueError(f"{what}: data and cols must be (n_rows, K) "
                         f"alike, got {tuple(data.shape)} and "
                         f"{tuple(cols.shape)}")
    if data.device.type != "cuda":
        return
    if data.dtype != torch.float32 or cols.dtype != torch.int32:
        raise TypeError(f"{what}: the CUDA kernel takes float32 data and "
                        f"int32 cols, got {data.dtype} and {cols.dtype}")
    if not (data.is_contiguous() and cols.is_contiguous()):
        raise ValueError(f"{what}: the CUDA kernel takes contiguous planes")
    if cols.device != data.device:
        raise ValueError(f"{what}: data and cols lie on {data.device} and "
                         f"{cols.device}")
    if data.numel() >= 2**31:
        raise ValueError(f"{what}: {data.numel()} slots exceed 32-bit "
                         f"indexing")


def check_vector(v: torch.Tensor, like: torch.Tensor, what: str) -> None:
    """A dense float32 vector on the planes' card."""
    if v.dim() != 1:
        raise ValueError(f"{what}: expected a vector, got shape "
                         f"{tuple(v.shape)}")
    if like.device.type != "cuda":
        return
    if v.device != like.device:
        raise ValueError(f"{what}: the vector lies on {v.device}, the "
                         f"matrix on {like.device}")
    if v.dtype != torch.float32 or not v.is_contiguous():
        raise TypeError(f"{what}: the CUDA kernel takes a contiguous "
                        f"float32 vector, got {v.dtype}")


#: Rows of one run (the kernel's threads), at most; the shared memory two
#: runs of both planes take without the opt-in, and a CTA's opt-in maximum
#: on an H100.
RUN_ROWS = 256
RUN_SMEM = 48 * 1024
SMEM_OPTIN = 232448


def run_rows(k: int) -> int:
    """Rows of one run of the CUDA kernel for K slots a row: 256, or the
    most multiples of 32 whose two runs of data and cols (16 K bytes a
    row) fit 48 KB; 32 where fewer would (up to K = 453, with the opt-in);
    fewer rows only for wider rows still."""
    per_row = 16 * max(k, 1)
    r = min(RUN_ROWS, RUN_SMEM // per_row // 32 * 32)
    if r < 32:
        r = min(32, (SMEM_OPTIN - 64) // per_row)
    if r < 1:
        raise ValueError(f"spmv_ell: rows of {k} slots exceed the shared "
                         f"memory of one CTA ({SMEM_OPTIN} B)")
    return r


def spmv_ell(data: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, A in ELL format: data/cols (n_rows, K), x (n_cols,).
    ``x`` of shape (B, n_cols) gives y of shape (B, n_rows): B right-hand
    sides in ONE launch that reads A once, each row bit-equal to its own
    single launch."""
    check_ell(data, cols, "spmv_ell")
    lanes = x.shape[0] if x.dim() == 2 else 1
    check_vector(x[0] if x.dim() == 2 else x, data, "spmv_ell")
    if _build.is_cpu(data, "spmv_ell"):
        return ref.spmv_ell(data, cols, x)
    if not x.is_contiguous():
        raise TypeError("spmv_ell: the CUDA kernel takes contiguous "
                        "right-hand sides")
    n, k = data.shape
    out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
    lib = _build.load("spmv_ell")
    with _build.on_device(data):
        err = lib.spmv_ell_launch(data.data_ptr(), cols.data_ptr(),
                                  x.data_ptr(), out.data_ptr(), n, k,
                                  run_rows(k), lanes, x.shape[-1],
                                  _build.stream())
    _build.check(err, "spmv_ell_launch")
    spmv_ell.launches += 1
    spmv_ell.batched_launches += x.dim() == 2
    return out


spmv_ell.launches = 0
#: the launches that took a batch of right-hand sides ((B, n_cols) x)
spmv_ell.batched_launches = 0


# -- host-side ELL construction helpers (numpy; data prep, not hot path) ------

def dense_to_ell(a: np.ndarray, k: Optional[int] = None):
    """Convert a dense matrix to ELL (data, cols) with per-row padding.

    An explicit ``k`` smaller than some row's nnz raises (naming the
    offending row) — silently dropping entries would corrupt the
    operator.
    """
    n = a.shape[0]
    nnz_per_row = (a != 0).sum(axis=1)
    if k is None:
        k = int(nnz_per_row.max()) if n else 1
    elif n and nnz_per_row.max() > k:
        bad = int(np.argmax(nnz_per_row > k))
        raise ValueError(
            f"ELL k={k} cannot hold row {bad} with {int(nnz_per_row[bad])} "
            f"nonzeros (max row nnz is {int(nnz_per_row.max())})")
    data = np.zeros((n, k), a.dtype)
    cols = np.zeros((n, k), np.int32)
    for i in range(n):
        idx = np.nonzero(a[i])[0]
        data[i, : len(idx)] = a[i, idx]
        cols[i, : len(idx)] = idx
    return data, cols


def poisson2d_ell(side: int, dtype=np.float32):
    """ELL form of the 2D 5-point Poisson matrix on a side x side grid —
    the canonical SPD test operator (the paper's CG datasets are SPD)."""
    n = side * side
    k = 5
    data = np.zeros((n, k), dtype)
    cols = np.zeros((n, k), np.int32)
    for r in range(side):
        for c in range(side):
            i = r * side + c
            slot = 0
            data[i, slot] = 4.0
            cols[i, slot] = i
            slot += 1
            for rr, cc in ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1)):
                if 0 <= rr < side and 0 <= cc < side:
                    data[i, slot] = -1.0
                    cols[i, slot] = rr * side + cc
                    slot += 1
    return data, cols
