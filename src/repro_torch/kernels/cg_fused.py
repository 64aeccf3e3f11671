"""PERKS conjugate gradient on Hopper: the port of
``repro/kernels/cg_fused.py``.

``cg_fused(data, cols, b, iters=)`` runs ``iters`` textbook CG iterations
for A x = b from x0 = 0 (A in ELL format) in ONE cooperative persistent
launch (``csrc/cg_fused.cu``) and returns (x, rr), rr = ||r||^2 of shape
(1,). Each CTA owns a contiguous range of rows and keeps x, r, p and Ap of
those rows in shared memory for the whole launch; the CTAs meet only at the
two dot products of an iteration (tagged reduction rounds), and form the p
they gather from other CTAs' r and last p in device memory; the matrix is:

* ``resident_matrix=False`` — streamed from device memory every iteration
  (the paper's VEC policy);
* ``resident_matrix=True`` — kept in shared memory (MIX/MAT), its leading
  ``matrix_rows`` rows (default all) split evenly over the CTAs, the rest
  streamed. On the H100 a large A does not fit beside the vectors, so
  ``matrix_rows < n`` is the H100 form of MIX (the planner's
  ``matrix_fraction``).

``b`` of shape (B, n) runs B systems on the one A in one launch: A's
cached share is kept once, the vectors once a lane, and each reduction
round carries the B lanes' sums (``csrc/cg_fused.cu``). A plan that asks
more shared memory than a CTA holds raises ``ValueError`` with the
capacity. A CPU tensor runs the plain torch version
(``ref.cg_run``); a CUDA tensor launches the kernel or raises — there is no
fallback. ``block_rows`` is the reference's streaming tile, accepted for
its signature and not used. The wrapper counts its launches in
``launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.spmv_ell import check_ell, check_vector

#: Bytes of shared memory per owned row for x, r, p and Ap (float32), a
#: right-hand side.
VECTOR_BYTES_PER_ROW = 16
#: Bytes of shared memory a right-hand side for its warps' partial sums
#: (one float a warp of the 1024-thread CTA).
WARP_PART_BYTES = 128


#: Right-hand sides one launch takes at most (the values a tagged round
#: carries, ``KRY_WARPS`` in ``csrc/krylov_common.cuh``).
MAX_LANES = 32


def cg_fused(
    data: torch.Tensor,
    cols: torch.Tensor,
    b: torch.Tensor,
    *,
    iters: int,
    resident_matrix: bool = True,
    block_rows: int = 256,
    matrix_rows: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` CG iterations for A x = b in one launch; returns (x, rr).
    ``b`` of shape (B, n) solves B systems on the one A in ONE launch
    (B <= ``MAX_LANES``; x (B, n), rr (B,)), each lane bit-equal to its own
    launch."""
    check_ell(data, cols, "cg_fused")
    lanes = b.shape[0] if b.dim() == 2 else 1
    check_vector(b[0] if b.dim() == 2 else b, data, "cg_fused")
    n, k = data.shape
    if b.shape[-1] != n:
        raise ValueError(f"cg_fused: b has {b.shape[-1]} rows, A has {n}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    if not resident_matrix:
        matrix_rows = 0
    elif matrix_rows is None:
        matrix_rows = n
    if not 0 <= matrix_rows <= n:
        raise ValueError(f"matrix_rows={matrix_rows} outside [0, {n}]")
    if _build.is_cpu(data, "cg_fused"):
        if b.dim() == 2:
            runs = [ref.cg_run(data, cols, b[i], iters) for i in range(lanes)]
            return (torch.stack([x for x, _ in runs]),
                    torch.stack([rr for _, rr in runs]))
        x, rr = ref.cg_run(data, cols, b, iters)
        return x, rr.reshape(1)
    if n == 0:
        raise ValueError("cg_fused: empty system")
    if lanes > MAX_LANES:
        raise ValueError(f"cg_fused: at most {MAX_LANES} right-hand sides "
                         f"a launch, got {lanes}")
    if not b.is_contiguous():
        raise ValueError("cg_fused: the CUDA kernel takes a contiguous b")
    lib = _build.load("cg_fused")
    with _build.on_device(data):
        sms = torch.cuda.get_device_properties(data.device).multi_processor_count
        what = ("x, r, p and Ap" if lanes == 1
                else f"x, r, p and Ap of {lanes} right-hand sides")
        stride, ca, smem = _build.fit(lib, "cg_fused", n, k, sms, matrix_rows,
                                      VECTOR_BYTES_PER_ROW * lanes, what,
                                      extra=WARP_PART_BYTES * lanes)
        x = torch.empty_like(b)
        rr = torch.empty(lanes, dtype=b.dtype, device=b.device)
        vecs = torch.empty(2 * lanes * n, dtype=b.dtype, device=b.device)
        tags = _build.tag_words(sms, b.device, values=MAX_LANES)
        err = lib.cg_fused_launch(
            data.data_ptr(), cols.data_ptr(), b.data_ptr(), x.data_ptr(),
            rr.data_ptr(), vecs.data_ptr(), tags.data_ptr(), n, k,
            iters, stride, ca, sms, smem, lanes, _build.stream())
    _build.check(err, "cg_fused_launch")
    cg_fused.launches += 1
    cg_fused.batched_launches += b.dim() == 2
    return x, rr


cg_fused.launches = 0
#: the launches that solved a batch ((B, n) b) of right-hand sides
cg_fused.batched_launches = 0
