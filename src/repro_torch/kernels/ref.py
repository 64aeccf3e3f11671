"""Plain torch versions of the port's kernels (the port's
``repro/kernels/ref.py``: the stencils, the two SpMVs and conjugate
gradient).

They are what the CPU path runs and what ``chip_smoke.py`` holds each CUDA
kernel against on the card. No custom kernel, no scratch: torch ops only.
The SpMVs sum a row's slots in slot order, one rounded product added at a
time, which is the CUDA kernels' order; the CG iteration follows the
reference's order of operations, ``_safe_div`` included.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.common import StencilSpec


def stencil_step(x: torch.Tensor, spec: StencilSpec,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One time step: interior updated, outermost ``radius`` cells frozen."""
    return spec.apply(x, out=out)


def stencil_run(x: torch.Tensor, spec: StencilSpec, steps: int) -> torch.Tensor:
    """``steps`` time steps, ping-ponging two buffers it owns; ``x`` is
    never written."""
    cur = x.clone()
    if steps == 0:
        return cur
    nxt = torch.empty_like(x)
    for _ in range(steps):
        spec.apply(cur, out=nxt)
        cur, nxt = nxt, cur
    return cur


# -- ELL and SELL-C-σ SpMV ----------------------------------------------------

def spmv_ell(data: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for A in ELL format: ``data``/``cols`` (n_rows, K), padding
    slots data 0 and column 0 (they add 0 * x[0] = 0). Slot order."""
    acc = torch.zeros(data.shape[0], dtype=x.dtype, device=x.device)
    for j in range(data.shape[1]):
        acc = acc + data[:, j] * x[cols[:, j]]
    return acc


def spmv_sell(data: torch.Tensor, cols: torch.Tensor,
              slice_offsets: torch.Tensor, slice_k: torch.Tensor,
              x: torch.Tensor, *, c: int, k_max: int) -> torch.Tensor:
    """y_perm = A_perm @ x for A in SELL-C-σ flat slot-major layout, in the
    permuted padded row order (n_slices * c,), as the reference returns it.

    One pass per slot j < ``k_max`` over every permuted row; a row whose
    slice is narrower than j adds nothing (a masked 0), so each row sums
    exactly its slice's slots in slot order. ``k_max`` must be at least
    every ``slice_k``."""
    n_slices = slice_offsets.shape[0]
    p = torch.arange(n_slices * c, device=x.device)
    s = torch.div(p, c, rounding_mode="floor")
    base = slice_offsets.to(torch.int64)[s] + (p - s * c)
    width = slice_k[s]
    acc = torch.zeros(n_slices * c, dtype=x.dtype, device=x.device)
    for j in range(k_max):
        live = width > j
        e = torch.where(live, base + j * c, 0)
        acc = acc + torch.where(live, data[e] * x[cols[e]], 0.0)
    return acc


# -- conjugate gradient (one iteration; cg_run is the fused kernel's plain
# -- version) ---------------------------------------------------------------

def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a/b with 0 when b underflows to 0 (or is NaN) — keeps fully converged
    CG iterations (rr -> exact 0 in float32) as fixed points instead of
    NaNs. Stays on the device: no host read, so a CUDA graph can hold it."""
    return torch.where(b.abs() > 0, a / b, 0.0)


CGState = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def cg_iteration_matvec(state: CGState,
                        matvec: Callable[[torch.Tensor], torch.Tensor],
                        dot: Callable = torch.dot,
                        out: Optional[CGState] = None) -> CGState:
    """One textbook CG iteration with a pluggable SpMV and reduction;
    state = (x, r, p, rr). With ``out`` (buffers like ``state``, not
    aliasing it) x, r and p are written there; rr is always a new
    tensor."""
    x, r, p, rr = state
    ap = matvec(p)
    alpha = _safe_div(rr, dot(p, ap))
    if out is None:
        x = x + alpha * p
        r = r - alpha * ap
    else:
        x = torch.add(x, alpha * p, out=out[0])
        r = torch.sub(r, alpha * ap, out=out[1])
    rr_new = dot(r, r)
    beta = _safe_div(rr_new, rr)
    if out is None:
        p = r + beta * p
    else:
        p = torch.add(r, beta * p, out=out[2])
    return (x, r, p, rr_new)


def cg_iteration(state: CGState, data: torch.Tensor,
                 cols: torch.Tensor) -> CGState:
    """One textbook CG iteration on ELL-format A. state = (x, r, p, rr)."""
    return cg_iteration_matvec(state, lambda p: spmv_ell(data, cols, p))


def cg_run(data: torch.Tensor, cols: torch.Tensor, b: torch.Tensor,
           iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` CG iterations from x0 = 0 (the plain version of
    ``cg_fused``); returns (x, rr) with rr a 0-dim tensor."""
    state = (torch.zeros_like(b), b, b, torch.dot(b, b))
    for _ in range(iters):
        state = cg_iteration(state, data, cols)
    return state[0], state[3]
