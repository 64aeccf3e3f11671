"""Plain torch versions of the port's kernels (the port's
``repro/kernels/ref.py``: the stencils, the two SpMVs, conjugate
gradient, BiCGStab, GMRES(m), the Mamba2 SSD scan and decode attention).

They are what the CPU path runs and what ``chip_smoke.py`` holds each CUDA
kernel against on the card. No custom kernel, no scratch: torch ops only.
The SpMVs sum a row's slots in slot order, one rounded product added at a
time, which is the CUDA kernels' order; the CG iteration follows the
reference's order of operations, ``_safe_div`` included; so do the
BiCGStab iteration and the GMRES(m) cycle, whose small least-squares solve
is a Givens QR in torch ops (``hessenberg_lstsq``) where the reference
calls ``jnp.linalg.lstsq``. The Krylov steps also take B lanes at once,
each lane computing the bits of its instance alone.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.common import StencilSpec
from repro_torch.kernels.vdot import plain_vdot


def stencil_step(x: torch.Tensor, spec: StencilSpec,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One time step: interior updated, outermost ``radius`` cells frozen.
    ``x`` of rank ``spec.ndim + 1`` is ``[B, ...]``, B domains each stepped
    on its own."""
    if x.dim() == spec.ndim + 1:
        out = torch.empty_like(x) if out is None else out
        for i in range(x.shape[0]):
            spec.apply(x[i], out=out[i])
        return out
    return spec.apply(x, out=out)


def stencil_run(x: torch.Tensor, spec: StencilSpec, steps: int) -> torch.Tensor:
    """``steps`` time steps, ping-ponging two buffers it owns; ``x`` is
    never written. ``x`` of rank ``spec.ndim + 1`` is ``[B, ...]``, each
    domain run on its own (so each gets its single run's bits)."""
    if x.dim() == spec.ndim + 1:
        return torch.stack([stencil_run(d, spec, steps) for d in x])
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
    slots data 0 and column 0 (they add 0 * x[0] = 0). Slot order. ``x`` of
    shape (B, n_cols) gives (B, n_rows): each row of x on its own."""
    acc = torch.zeros(x.shape[:-1] + (data.shape[0],), dtype=x.dtype,
                      device=x.device)
    for j in range(data.shape[1]):
        acc = acc + data[:, j] * x[..., cols[:, j]]
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


def _lanes(s: torch.Tensor) -> torch.Tensor:
    """A scalar of a step as a factor of its vectors: a 0-dim tensor as
    it is, a batch's (B,) lane scalars as a (B, 1) view (no launch)."""
    return s.unsqueeze(-1) if s.dim() else s


CGState = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def cg_iteration_matvec(state: CGState,
                        matvec: Callable[[torch.Tensor], torch.Tensor],
                        dot: Callable = torch.dot,
                        out: Optional[CGState] = None) -> CGState:
    """One textbook CG iteration with a pluggable SpMV and reduction;
    state = (x, r, p, rr). With ``out`` (buffers like ``state``, not
    aliasing it) x, r and p are written there; rr is always a new tensor.
    A batched state (x, r, p of shape (B, n), rr of shape (B,); the matvec
    and the dot taking such stacks) steps every lane as it would step
    alone: alpha and beta are (B,) and scale their own lane's row."""
    x, r, p, rr = state
    ap = matvec(p)
    alpha = _lanes(_safe_div(rr, dot(p, ap)))
    if out is None:
        x = x + alpha * p
        r = r - alpha * ap
    else:
        x = torch.add(x, alpha * p, out=out[0])
        r = torch.sub(r, alpha * ap, out=out[1])
    rr_new = dot(r, r)
    beta = _lanes(_safe_div(rr_new, rr))
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


# -- BiCGStab (one iteration; bicgstab_run is the fused kernel's plain
# -- version) ----------------------------------------------------------------

BiCGStabState = tuple[torch.Tensor, ...]


def bicgstab_iteration_matvec(state: BiCGStabState,
                              matvec: Callable[[torch.Tensor], torch.Tensor],
                              dot: Callable = torch.dot,
                              out: Optional[BiCGStabState] = None
                              ) -> BiCGStabState:
    """One BiCGStab iteration (van der Vorst 1992) with a pluggable SpMV
    and reduction; state = (x, r, rhat, p, v, rho, alpha, omega, rr).

    Every quotient goes through ``_safe_div``, so a converged state (r
    exactly 0) is a fixed point. With ``out`` (buffers like ``state``, not
    aliasing it) x, r and p are written there; rhat is returned as it came
    (it never changes), v and the scalars are new tensors. A batched state
    (vectors (B, n), scalars (B,); the matvec and the dot taking such
    stacks) steps every lane as it would step alone, as
    ``cg_iteration_matvec`` does."""
    x, r, rhat, p, v, rho, alpha, omega, _ = state
    rho_new = dot(rhat, r)
    beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
    d = _lanes(beta) * (p - _lanes(omega) * v)
    p = r + d if out is None else torch.add(r, d, out=out[3])
    v = matvec(p)
    alpha = _safe_div(rho_new, dot(rhat, v))
    s = r - _lanes(alpha) * v
    t = matvec(s)
    omega = _safe_div(dot(t, s), dot(t, t))
    x = x + _lanes(alpha) * p
    if out is None:
        x = x + _lanes(omega) * s
        r = s - _lanes(omega) * t
    else:
        x = torch.add(x, _lanes(omega) * s, out=out[0])
        r = torch.sub(s, _lanes(omega) * t, out=out[1])
    return (x, r, rhat, p, v, rho_new, alpha, omega, dot(r, r))


def bicgstab_initial_state(b: torch.Tensor,
                           dot: Callable = torch.dot) -> BiCGStabState:
    """x = 0: r = rhat = b, p = v = 0, and rho = alpha = omega = 1, so the
    first iteration reduces to p = r. ``b`` of (B, n) gives every lane its
    own (B,) scalars."""
    one = torch.ones(b.shape[:-1], dtype=b.dtype, device=b.device)
    zero = torch.zeros_like(b)
    return (zero, b, b, zero, zero, one, one, one, dot(b, b))


def bicgstab_run(data: torch.Tensor, cols: torch.Tensor, b: torch.Tensor,
                 iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``iters`` BiCGStab iterations from x0 = 0 on ELL-format A (the plain
    version of ``bicgstab_fused``); returns (x, rr), rr a 0-dim tensor."""
    state = bicgstab_initial_state(b)
    for _ in range(iters):
        state = bicgstab_iteration_matvec(
            state, lambda q: spmv_ell(data, cols, q))
    return state[0], state[8]


# -- restarted GMRES(m) (gmres_cycle_update is the cycle kernel's plain
# -- version) -----------------------------------------------------------------
#
# One code path runs B lanes, a single instance being B = 1, and every sum
# a lane makes has an order that does not depend on B: the projections on
# the basis are ``proj`` lane dots (``kernels.vdot``: the lane pairs each
# row of its basis with its own vector), their combinations are products
# summed over the basis axis (the rows in one fixed order whatever the
# other axes hold), and the Givens rotations and the back substitution are
# elementwise. So a lane of a batch computes the bits of its instance
# alone. Inside, the basis is V (m+1, B, n), so that a row of every lane,
# V[j], is one contiguous (B, n) block, and H and R keep the lane axis
# last; the functions below take and give the lane axis first.

def _single(matvec, dot):
    """A vector-at-a-time SpMV and dot as the lane path calls them, on
    (1, n) stacks."""
    return (lambda v: matvec(v[0]).unsqueeze(0),
            lambda a, b: dot(a[0], b[0]).unsqueeze(0))


def _arnoldi_lanes(x: torch.Tensor, b: torch.Tensor, matvec, m: int, dot,
                   proj) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CGS2 Arnoldi of B lanes from x, b (B, n): V (m+1, B, n), H
    (m+1, m, B) and beta (B,)."""
    lanes, n = b.shape
    r = b - matvec(x)
    beta = torch.sqrt(dot(r, r))
    V = torch.zeros((m + 1, lanes, n), dtype=b.dtype, device=b.device)
    H = torch.zeros((m + 1, m, lanes), dtype=b.dtype, device=b.device)
    torch.mul(r, _lanes(_safe_div(1.0, beta)), out=V[0])
    for j in range(m):
        basis = V[:j + 1]
        w = matvec(V[j])
        h1 = proj(basis, w)
        w = w - (h1.unsqueeze(-1) * basis).sum(0)
        h2 = proj(basis, w)
        w = w - (h2.unsqueeze(-1) * basis).sum(0)
        hn = torch.sqrt(dot(w, w))
        torch.add(h1, h2, out=H[:j + 1, j])
        H[j + 1, j] = hn
        torch.mul(w, _lanes(_safe_div(1.0, hn)), out=V[j + 1])
    return V, H, beta


def _lstsq_lanes(H: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """``hessenberg_lstsq`` of B lanes: H (m+1, m, B), beta (B,) -> y
    (m, B)."""
    m, lanes = H.shape[1], H.shape[2]
    g = torch.zeros((m + 1, 1, lanes), dtype=H.dtype, device=H.device)
    g[0, 0] = beta
    R = torch.cat([H, g], dim=1)                 # [H | beta e1]
    for j in range(m):
        a, c = R[j, j], R[j + 1, j]
        rad = torch.hypot(a, c)
        live = rad > 0
        cos = torch.where(live, a / rad, 1.0)
        sin = torch.where(live, c / rad, 0.0)
        top, bot = R[j, j:], R[j + 1, j:]
        ct, sb, cb, st = cos * top, sin * bot, cos * bot, sin * top
        torch.add(ct, sb, out=top)
        torch.sub(cb, st, out=bot)
    # back substitution by columns: y_i, then its share taken from the
    # right-hand sides of the rows above
    rhs = R[:, m]
    ys = []
    for i in reversed(range(m)):
        ys.append(_safe_div(rhs[i], R[i, i]))
        if i:
            torch.sub(rhs[:i], ys[-1] * R[:i, i], out=rhs[:i])
    return torch.stack(ys[::-1])


def gmres_arnoldi(x: torch.Tensor, b: torch.Tensor,
                  matvec: Callable[[torch.Tensor], torch.Tensor], m: int,
                  dot: Callable = torch.dot, proj: Callable = plain_vdot
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The Arnoldi half of one GMRES(m) cycle from iterate ``x``, with CGS2
    (two classical Gram-Schmidt passes): returns the basis V (m+1, n), the
    Hessenberg matrix H (m+1, m) and beta = ||b - A x|| of shape (1,), as
    ``gmres_cycle_fused`` returns them beside the new iterate; for lanes x,
    b (B, n) (the matvec and the dot taking such stacks), V (B, m+1, n), H
    (B, m+1, m) and beta (B, 1).

    Step j projects on the j+1 rows of V built so far with the lane dot
    ``proj`` (a plain ``torch.dot`` a pair by default, ``kernels.vdot`` on
    the loop tiers); the reference projects on all m+1 rows, whose others
    are still 0, by matrix products, so the two differ only in the order of
    the sums."""
    if x.dim() == 1:
        mv, dt = _single(matvec, dot)
        V, H, beta = _arnoldi_lanes(x.unsqueeze(0), b.unsqueeze(0), mv, m,
                                    dt, proj)
        return V[:, 0], H[..., 0], beta
    V, H, beta = _arnoldi_lanes(x, b, matvec, m, dot, proj)
    return V.transpose(0, 1), H.permute(2, 0, 1), beta.unsqueeze(-1)


def hessenberg_lstsq(H: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """y minimising ||H y - beta e1|| for the (m+1, m) upper Hessenberg H
    of one GMRES cycle (beta of shape (1,)), or each lane's for H (B, m+1,
    m) and beta (B, 1) (y (B, m)), by Givens rotations written out
    elementwise and a back substitution by columns, in torch ops: nothing
    is read on the host, so a CUDA graph can hold it (the reference's
    ``jnp.linalg.lstsq`` is an SVD; on the card ``torch.linalg.lstsq``
    offers only a full-rank QR solve).

    After an Arnoldi breakdown (h_{j+1,j} = 0) the later columns of H are
    0: a rotation of a zero pair is the identity, and the back
    substitution's ``_safe_div`` gives those coordinates 0, which is the
    minimum-norm answer the SVD gives."""
    if H.dim() == 2:
        return _lstsq_lanes(H.unsqueeze(-1), beta.reshape(1))[:, 0]
    return _lstsq_lanes(H.permute(1, 2, 0), beta.reshape(-1)).t()


def gmres_cycle_update(x: torch.Tensor, b: torch.Tensor,
                       matvec: Callable[[torch.Tensor], torch.Tensor], m: int,
                       dot: Callable = torch.dot,
                       out: Optional[torch.Tensor] = None,
                       proj: Callable = plain_vdot
                       ) -> tuple[torch.Tensor, ...]:
    """One GMRES(m) cycle up to the new iterate (the plain version of
    ``gmres_cycle_fused``): the Arnoldi basis (``gmres_arnoldi``), the
    least-squares solve (``hessenberg_lstsq``) and x + y V[:m]; returns
    (V, H, beta, x_new), each with a leading lane axis for lanes x, b
    (B, n). With ``out`` (a buffer like x, not aliasing it) x_new is
    written there."""
    single = x.dim() == 1
    if single:
        matvec, dot = _single(matvec, dot)
        x, b = x.unsqueeze(0), b.unsqueeze(0)
    V, H, beta = _arnoldi_lanes(x, b, matvec, m, dot, proj)
    y = _lstsq_lanes(H, beta)
    x_new = torch.add(x, (y.unsqueeze(-1) * V[:m]).sum(0),
                      out=None if out is None else out.view(x.shape))
    if single:
        return (V[:, 0], H[..., 0], beta,
                x_new[0] if out is None else out)
    return V.transpose(0, 1), H.permute(2, 0, 1), beta.unsqueeze(-1), x_new


def gmres_cycle_matvec(state: tuple[torch.Tensor, torch.Tensor],
                       matvec: Callable[[torch.Tensor], torch.Tensor],
                       b: torch.Tensor, m: int, dot: Callable = torch.dot,
                       out: Optional[torch.Tensor] = None,
                       proj: Callable = plain_vdot
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One GMRES(m) restart cycle: ``gmres_cycle_update``, then the
    residual recomputed with one more SpMV; state = (x, rr), x (n,) or
    lanes (B, n). With ``out`` (a buffer like x, not aliasing it) x is
    written there."""
    x, _ = state
    x = gmres_cycle_update(x, b, matvec, m, dot=dot, out=out, proj=proj)[3]
    r = b - matvec(x)
    return (x, dot(r, r))


def gmres_run(data: torch.Tensor, cols: torch.Tensor, b: torch.Tensor,
              cycles: int, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``cycles`` GMRES(m) restart cycles from x0 = 0 on ELL-format A;
    returns (x, rr), rr a 0-dim tensor."""
    state = (torch.zeros_like(b), torch.dot(b, b))
    for _ in range(cycles):
        state = gmres_cycle_matvec(state, lambda q: spmv_ell(data, cols, q),
                                   b, m)
    return state


# -- Mamba2 / SSD scan --------------------------------------------------------

def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
             return_state: bool = False):
    """Selective-state-space (Mamba2 SSD) reference via the per-step
    recurrence, single sequence:

      x (T, H, P), dt (T, H) softplus-activated steps, a (H,) negative
      decays, b/c (T, N) input/output projections (shared across heads),
      d (H,) skip. Returns y (T, H, P), and with ``return_state`` also the
      state after the last step, h_T (H, N, P).

      h_t = exp(dt_t * a_h) * h_{t-1} + dt_t * outer(b_t, x_t)
      y_t = c_t @ h_t + d_h * x_t

    The state starts as zeros of ``x``'s dtype, as the reference's does;
    callers upcast bf16 streams first.
    """
    t_len, h, p = x.shape
    n = b.shape[-1]
    state = torch.zeros((h, n, p), dtype=x.dtype, device=x.device)
    ys = []
    for t in range(t_len):
        xt, dtt, bt, ct = x[t], dt[t], b[t], c[t]
        decay = torch.exp(dtt * a)
        upd = dtt[:, None, None] * bt[None, :, None] * xt[:, None, :]
        state = decay[:, None, None] * state + upd
        ys.append(torch.einsum("n,hnp->hp", ct, state) + d[:, None] * xt)
    y = (torch.stack(ys) if ys else
         torch.zeros((0, h, p), dtype=x.dtype, device=x.device))
    return (y, state) if return_state else y


# -- decode attention ---------------------------------------------------------

def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token GQA attention against a KV cache (the oracle of
    ``kernels/decode_attn.py``): q (B, Hq, D); k, v (B, S, Hkv, D),
    Hq % Hkv == 0; ``length`` optional (B,) valid-prefix lengths, the rest
    masked with -inf. Logits in q's dtype, the softmax in float32, cast
    back to q's dtype for the value product. Returns (B, Hq, D)."""
    bsz, hq, dim = q.shape
    s, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(bsz, hkv, hq // hkv, dim)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k) / torch.sqrt(
        torch.tensor(float(dim))).to(q.dtype)
    if length is not None:
        mask = torch.arange(s, device=q.device)[None, :] < length[:, None]
        logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, v)
    return out.reshape(bsz, hq, dim)
