"""The Mamba2 SSD layer ops: the port of ``repro/nn/ssd.py``.

``ssd_chunked`` is the prefill's chunk scan. On a CUDA tensor it launches
the hand-written scan (``kernels/ssm_scan.py``, ``csrc/ssm_scan.cu``: the
state h kept on chip for the whole sequence), with x, b and c upcast to
float32 (exact) and dt as given (float32), y cast back to x's dtype as the
reference casts each chunk; a failed launch raises. On a CPU tensor it runs
the plain chunked form below, which follows the reference op for op (a
chunk that does not divide T leaves a shorter last chunk, as the kernel
does; the reference asserts T % chunk == 0). ``ssd_step`` and the depthwise
causal conv are plain torch on every device, as the reference computes
them outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ssm_scan as _kssm


def _chunk(h_prev, xc, dtc, bc, cc, a32, d32, out_dtype):
    """One chunk of the reference's ``per_chunk``, every operand float32:
    xc (B,C,H,P), dtc (B,C,H), bc/cc (B,C,N), h_prev (B,H,N,P)."""
    g = dtc * a32[None, None, :]                        # (B,C,H) log decay
    cum = torch.cumsum(g, dim=1)                        # inclusive
    scores = torch.einsum("bin,bjn->bij", cc, bc)
    li = cum[:, :, None, :] - cum[:, None, :, :]        # (B,i,j,H)
    ck = xc.shape[1]
    causal = torch.tril(torch.ones((ck, ck), dtype=torch.bool,
                                   device=xc.device))
    # mask before exp: the upper triangle overflows exp for long chunks
    li = torch.where(causal[None, :, :, None], li,
                     torch.full((), -torch.inf, device=xc.device))
    m = torch.exp(li) * scores[..., None] * dtc[:, None]
    y = torch.einsum("bijh,bjhp->bihp", m, xc)
    y = y + torch.exp(cum)[..., None] * torch.einsum("bin,bhnp->bihp", cc,
                                                     h_prev)
    y = y + d32[None, None, :, None] * xc
    tail = torch.exp(cum[:, -1:, :] - cum)              # (B,C,H)
    upd = torch.einsum("bjh,bjn,bjhp->bhnp", tail * dtc, bc, xc)
    h_new = torch.exp(cum[:, -1])[:, :, None, None] * h_prev + upd
    return h_new, y.to(out_dtype)


def ssd_chunked(x, dt, a, b, c, d, *, chunk: int = 128,
                return_state: bool = False):
    """x (B,T,H,P); dt (B,T,H); a (H,); b,c (B,T,N); d (H,) -> y (B,T,H,P)
    in x's dtype. With ``return_state`` also returns the final state h
    (B,H,N,P) float32."""
    if x.device.type != "cpu":
        out = _kssm.ssd_scan(x.float(), dt.float(), a.float(), b.float(),
                             c.float(), d.float(), chunk=chunk,
                             return_state=return_state)
        if return_state:
            return out[0].to(x.dtype), out[1]
        return out.to(x.dtype)
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    ck = max(1, min(chunk, t))
    x32, dt32, b32, c32 = x.float(), dt.float(), b.float(), c.float()
    a32, d32 = a.float(), d.float()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for s0 in range(0, t, ck):
        sl = slice(s0, min(s0 + ck, t))
        state, y = _chunk(state, x32[:, sl], dt32[:, sl], b32[:, sl],
                          c32[:, sl], a32, d32, x.dtype)
        ys.append(y)
    y = (torch.cat(ys, dim=1) if ys else
         torch.zeros_like(x))
    return (y, state) if return_state else y


def ssd_step(h_prev, xt, dtt, a, bt, ct, d):
    """One decode step. h_prev (B,H,N,P); xt (B,H,P); dtt (B,H); bt,ct
    (B,N). Returns (h_new, yt (B,H,P)); h_prev is not written."""
    xt32 = xt.float()
    dt32 = dtt.float()
    decay = torch.exp(dt32 * a[None, :])                # (B,H)
    upd = dt32[..., None, None] * torch.einsum("bn,bhp->bhnp", bt.float(),
                                               xt32)
    h_new = decay[..., None, None] * h_prev + upd
    yt = torch.einsum("bn,bhnp->bhp", ct.float(), h_new)
    yt = yt + d[None, :, None] * xt32
    return h_new, yt.to(xt.dtype)


def causal_conv1d(x, w, bias=None):
    """Depthwise causal conv over time. x (B,T,C); w (K,C). Left-pads
    K-1."""
    k = w.shape[0]
    t = x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:t, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + t, :] * w[i][None, None, :]
    if bias is not None:
        out = out + bias[None, None, :]
    return out


def causal_conv1d_step(state, xt, w, bias=None):
    """One decode step of the depthwise causal conv. state (B,K-1,C) holds
    the last K-1 inputs; xt (B,C). Returns (new state, out (B,C)); state
    is not written."""
    window = torch.cat([state, xt[:, None, :]], dim=1)  # (B,K,C)
    # summed in float32 and rounded once, as XLA's dot
    out = torch.einsum("bkc,kc->bc", window.float(), w.float()).to(
        window.dtype)
    if bias is not None:
        out = out + bias[None, :]
    return window[:, 1:], out
