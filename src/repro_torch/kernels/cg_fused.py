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
cached share is kept once, the vectors once a lane (lane-minor, the lanes
padded to the kernel's width ``lane_width(B)``), every lane goes through
one pass over a CTA's rows, and each reduction round carries the B lanes'
sums (``csrc/cg_fused.cu``). ``smem_layout`` is a launch's shared memory,
which the planner's batched resident plans fit to as well. A plan that
asks more shared memory than a CTA holds raises ``ValueError`` with the
capacity. A CPU tensor runs the plain torch version
(``ref.cg_run``); a CUDA tensor launches the kernel or raises — there is no
fallback. ``block_rows`` is the reference's streaming tile, accepted for
its signature and not used. The wrapper counts its launches in
``launches``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.spmv_ell import check_ell, check_vector

#: Bytes of shared memory per owned row for x, r, p and Ap (float32), a
#: lane of the kernel's width.
VECTOR_BYTES_PER_ROW = 16
#: Bytes of shared memory a lane of the kernel's width for its warps'
#: partial sums (one float a warp of the 1024-thread CTA).
WARP_PART_BYTES = 128
#: The kernel's static shared memory: sums, rr, beta and alpha of up to
#: 32 lanes (float32), beside the dynamic layout.
STATIC_SMEM_BYTES = 4 * 32 * 4


#: The published r and p of four lanes or more lie in tiles of this many
#: rows (``CG_TILE_ROWS`` in ``csrc/cg_fused.cu``), so their copy in device
#: memory is rounded up to whole tiles.
TILE_ROWS = 8
#: Right-hand sides one launch takes at most (the values a tagged round
#: carries, ``KRY_WARPS`` in ``csrc/krylov_common.cuh``).
MAX_LANES = 32


def lane_width(lanes: int) -> int:
    """The width LB the kernel is built for that runs ``lanes`` right-hand
    sides: ``lanes`` rounded up to a power of two (the padded lanes hold
    zeros and are neither summed nor written)."""
    return 1 << (lanes - 1).bit_length()


def smem_bytes(lanes: int) -> tuple[int, int]:
    """(bytes a row, bytes before the rows) of a launch's dynamic shared
    memory for ``lanes`` right-hand sides: x, r, p and Ap of each of the
    kernel's ``lane_width(lanes)`` lanes, and their warp partials."""
    lb = lane_width(lanes)
    return VECTOR_BYTES_PER_ROW * lb, WARP_PART_BYTES * lb


def smem_layout(n: int, k: int, ctas: int, matrix_rows: int,
                lanes: int) -> tuple[int, int, int]:
    """(rows a CTA owns at most, rows of A it caches, dynamic shared memory
    bytes) of a launch of ``lanes`` right-hand sides on an n-row, k-slot A
    over ``ctas`` CTAs with ``matrix_rows`` rows of A on chip: the warp
    partials, then x, r, p and Ap of every row (``smem_bytes``), then the
    cached rows of A (8 B a slot). The wrapper launches with it and the
    planner offers a batched resident plan only where it fits."""
    return _build.layout(n, k, ctas, matrix_rows, *smem_bytes(lanes))


def fit(lib, n: int, k: int, ctas: int, matrix_rows: int,
        lanes: int) -> tuple[int, int, int]:
    """``smem_layout`` checked against the built kernel ``lib``: raises
    ``ValueError`` with the capacity when a CTA cannot hold it or ``ctas``
    such CTAs are not co-resident."""
    what = ("x, r, p and Ap" if lanes == 1
            else f"x, r, p and Ap of {lanes} right-hand sides (as "
                 f"{lane_width(lanes)})")
    row_bytes, extra = smem_bytes(lanes)
    return _build.fit(lib, "cg_fused", n, k, ctas, matrix_rows, row_bytes,
                      what, extra=extra)


@functools.lru_cache(maxsize=256)
def _launch_layout(device: int, flags: tuple, n: int, k: int, ctas: int,
                   matrix_rows: int, lanes: int) -> tuple[int, int, int]:
    """``fit`` of the library built with ``flags`` on card ``device`` (the
    current one), asked of the card once a shape: it queries every lane
    width's kernel."""
    return fit(_build.load("cg_fused"), n, k, ctas, matrix_rows, lanes)


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
        stride, ca, smem = _launch_layout(
            torch.cuda.current_device(), _build.EXTRA_FLAGS, n, k, sms,
            matrix_rows, lanes)
        x = torch.empty_like(b)
        rr = torch.empty(lanes, dtype=b.dtype, device=b.device)
        # vg, then a byte a row: whether another CTA gathers it
        vecs = torch.empty(2 * lane_width(lanes) * -(-n // TILE_ROWS)
                           * TILE_ROWS + -(-n // 4), dtype=b.dtype,
                           device=b.device)
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
