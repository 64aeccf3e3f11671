"""PERKS Krylov kernels on Hopper: the port of
``repro/kernels/krylov_fused.py``.

* ``bicgstab_fused(data, cols, b, iters=)`` runs ``iters`` BiCGStab
  iterations for A x = b from x0 = 0 (A in ELL format) in ONE cooperative
  persistent launch (``csrc/bicgstab_fused.cu``) and returns (x, rr), rr =
  ||r||^2 of shape (1,). Each CTA keeps x, r, rhat, p, v and t of its rows
  in shared memory, meets the others only at three tagged reduction rounds
  an iteration, and forms the p and s it gathers from other CTAs' r, p and
  v in device memory; the matrix is streamed twice per iteration
  (``resident_matrix=False``, VEC) or kept on chip, its leading
  ``matrix_rows`` rows (default all) split evenly over the CTAs and the
  rest streamed (``resident_matrix=True``: MIX, partial when A does not fit
  beside the vectors).
* ``gmres_cycle_fused(data, cols, x, b, m=)`` runs one GMRES(m) restart
  cycle from iterate ``x`` (``csrc/gmres_cycle_fused.cu``) with the basis
  and the whole of A in shared memory: the Arnoldi process, the small
  least-squares solve and x + y V[:m], and returns (V (m+1, n),
  H (m+1, m), beta (1,), x_new (n,)); the first three are what the
  reference's kernel returns. The CTAs meet at ``gmres_cycle_rounds(m)``
  = 1 + 3m tagged rounds of up to 32 values, and form v_j at the SpMV's
  gather from the w published (in two buffers, by the step's parity)
  before the last ||w|| round.

A plan that asks more shared memory than a CTA holds raises ``ValueError``
with the capacity, read from the built kernel. A CPU tensor runs the plain
torch version (``ref.bicgstab_run``, ``ref.gmres_cycle_update``); a CUDA
tensor launches the kernel or raises — there is no fallback. ``block_rows``
is the reference's streaming tile, accepted for its signature and not used.
Each wrapper counts its launches in ``launches``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.spmv_ell import check_ell, check_vector

#: Bytes of shared memory per owned row for BiCGStab's x, r, rhat, p, v and
#: t (float32; s takes r's slot).
BICGSTAB_VECTOR_BYTES_PER_ROW = 24
#: Values one tagged round of the cycle kernel can sum (a warp each), the
#: words its launch zeroes; the projections of step j sum j+1 <= m values,
#: and the m+1 rows of H are one warp's lanes, so m <= GMRES_MAX_M.
GMRES_ROUND_VALUES = 32
GMRES_MAX_M = GMRES_ROUND_VALUES - 1


def gmres_cycle_rounds(m: int) -> int:
    """Tagged rounds of one ``gmres_cycle_fused`` cycle: beta, then h1,
    h2 and ||w|| a step."""
    return 1 + 3 * m


def bicgstab_fused(
    data: torch.Tensor,
    cols: torch.Tensor,
    b: torch.Tensor,
    *,
    iters: int,
    resident_matrix: bool = True,
    block_rows: int = 256,
    matrix_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` BiCGStab iterations for A x = b in one launch; returns
    (x, rr)."""
    check_ell(data, cols, "bicgstab_fused")
    check_vector(b, data, "bicgstab_fused")
    n, k = data.shape
    if b.shape[0] != n:
        raise ValueError(f"bicgstab_fused: b has {b.shape[0]} rows, A has "
                         f"{n}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if not resident_matrix:
        matrix_rows = 0
    elif matrix_rows is None:
        matrix_rows = n
    if not 0 <= matrix_rows <= n:
        raise ValueError(f"matrix_rows={matrix_rows} outside [0, {n}]")
    if _build.is_cpu(data, "bicgstab_fused"):
        x, rr = ref.bicgstab_run(data, cols, b, iters)
        return x, rr.reshape(1)
    if n == 0:
        raise ValueError("bicgstab_fused: empty system")
    lib = _build.load("bicgstab_fused")
    with _build.on_device(data):
        sms = torch.cuda.get_device_properties(data.device).multi_processor_count
        stride, ca, smem = _build.fit(lib, "bicgstab_fused", n, k, sms,
                                      matrix_rows,
                                      BICGSTAB_VECTOR_BYTES_PER_ROW,
                                      "six vectors")
        x = torch.empty_like(b)
        rr = torch.empty(1, dtype=b.dtype, device=b.device)
        vecs = torch.empty(3 * n, dtype=b.dtype, device=b.device)
        tags = _build.tag_words(sms, b.device)
        err = lib.bicgstab_fused_launch(
            data.data_ptr(), cols.data_ptr(), b.data_ptr(), x.data_ptr(),
            rr.data_ptr(), vecs.data_ptr(), tags.data_ptr(), n, k,
            iters, stride, ca, sms, smem, _build.stream())
    _build.check(err, "bicgstab_fused_launch")
    bicgstab_fused.launches += 1
    return x, rr


bicgstab_fused.launches = 0


def gmres_cycle_fused(
    data: torch.Tensor,
    cols: torch.Tensor,
    x: torch.Tensor,
    b: torch.Tensor,
    *,
    m: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One GMRES(m) cycle from iterate ``x`` in one launch; returns
    (V, H, beta, x_new)."""
    check_ell(data, cols, "gmres_cycle_fused")
    check_vector(x, data, "gmres_cycle_fused")
    check_vector(b, data, "gmres_cycle_fused")
    n, k = data.shape
    if b.shape[0] != n or x.shape[0] != n:
        raise ValueError(f"gmres_cycle_fused: x has {x.shape[0]} rows and b "
                         f"{b.shape[0]}, A has {n}")
    if not 1 <= m <= GMRES_MAX_M:
        raise ValueError(f"m must be in [1, {GMRES_MAX_M}], got {m}")
    if _build.is_cpu(data, "gmres_cycle_fused"):
        return ref.gmres_cycle_update(
            x, b, functools.partial(ref.spmv_ell, data, cols), m)
    if n == 0:
        raise ValueError("gmres_cycle_fused: empty system")
    lib = _build.load("gmres_cycle_fused")
    with _build.on_device(data):
        sms = torch.cuda.get_device_properties(data.device).multi_processor_count
        # per row: the m+1 basis entries and w (float32), and all of A
        stride, _, smem = _build.fit(lib, "gmres_cycle_fused", n, k, sms,
                                     n, 4 * (m + 2),
                                     f"{m + 1} basis entries and w")
        V = torch.empty((m + 1, n), dtype=b.dtype, device=b.device)
        H = torch.empty((m + 1, m), dtype=b.dtype, device=b.device)
        beta = torch.empty(1, dtype=b.dtype, device=b.device)
        x_new = torch.empty_like(x)
        u = torch.empty(2 * n, dtype=b.dtype, device=b.device)
        tags = _build.tag_words(sms, b.device, GMRES_ROUND_VALUES)
        err = lib.gmres_cycle_fused_launch(
            data.data_ptr(), cols.data_ptr(), x.data_ptr(), b.data_ptr(),
            V.data_ptr(), H.data_ptr(), beta.data_ptr(), x_new.data_ptr(),
            u.data_ptr(), tags.data_ptr(), n, k, m, stride, sms, smem,
            _build.stream())
    _build.check(err, "gmres_cycle_fused_launch")
    gmres_cycle_fused.launches += 1
    return V, H, beta, x_new


gmres_cycle_fused.launches = 0
