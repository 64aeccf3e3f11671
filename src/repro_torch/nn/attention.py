"""Attention as the models run it: the port of ``repro/nn/attention.py``.

``chunked_attention`` (prefill) is plain torch, chunked exactly as the
reference chunks it: per query chunk a first pass over the KV chunks
computes each row's log-sum-exp (running max and sum), a second sums the
partial outputs ``exp(logits - lse) @ v``. Logits accumulate in float32
and masked entries are filled with ``NEG`` (not -inf).

``decode_attention`` (one token against the KV cache) launches the
hand-written flash-decode kernel (``kernels/decode_attn.py``) on a CUDA
tensor; on a CPU tensor it runs the reference's arithmetic: float32
logits, the ``NEG`` fill, the softmax cast to ``v``'s dtype before the
value product.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attn as _decode_kernel

NEG = -1e30  # finite mask fill (avoids -inf NaN propagation)


def _pair_mask(qpos, kpos, causal: bool, window: Optional[int]):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        m &= (qpos[:, None] - kpos[None, :]) < window
    return m


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """q (B,Sq,Hq,D); k,v (B,Skv,Hkv,D); Hq % Hkv == 0. Returns (B,Sq,Hq,D)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    cq, ck = min(q_chunk, sq), min(kv_chunk, skv)
    if sq % cq or skv % ck:
        raise ValueError("pad the sequence to chunk multiples")
    nq, nk = sq // cq, skv // ck
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    qr = q.reshape(b, nq, cq, hkv, g, d)
    kr = k.reshape(b, nk, ck, hkv, d)
    vr = v.reshape(b, nk, ck, hkv, d)

    def logits(qc, kc, qpos, kpos):
        lg = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kc.float()) * scale
        msk = _pair_mask(qpos, kpos, causal, window)
        return torch.where(msk[None, None, None], lg,
                           torch.full((), NEG, device=dev))

    outs = []
    for qi in range(nq):
        qc = qr[:, qi]
        qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
        kposs = [kj * ck + torch.arange(ck, device=dev) for kj in range(nk)]
        m_run = torch.full((b, hkv, g, cq), NEG, device=dev)
        l_run = torch.zeros((b, hkv, g, cq), device=dev)
        for kj in range(nk):
            lg = logits(qc, kr[:, kj], qpos, kposs[kj])
            m_new = torch.maximum(m_run, lg.amax(dim=-1))
            l_run = (l_run * torch.exp(m_run - m_new)
                     + torch.exp(lg - m_new[..., None]).sum(dim=-1))
            m_run = m_new
        lse = m_run + torch.log(l_run)
        parts = []
        for kj in range(nk):
            lg = logits(qc, kr[:, kj], qpos, kposs[kj])
            p = torch.exp(lg - lse[..., None]).to(v.dtype)
            parts.append(torch.einsum("bkgqs,bskd->bkgqd", p, vr[:, kj]))
        out = torch.stack(parts).sum(dim=0)                  # (B,Hkv,G,cq,D)
        outs.append(out.reshape(b, hq, cq, d).transpose(1, 2))
    return torch.cat(outs, dim=1)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    length: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token GQA decode against a (full or length-masked) KV cache.
    q (B,Hq,D); k,v (B,S,Hkv,D); ``length`` (B,) int32 valid prefixes."""
    if q.device.type == "cuda":
        return _decode_kernel.decode_attention(q, k, v, length=length)
    b, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    lg = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) / (d ** 0.5)
    if length is not None:
        msk = torch.arange(s, device=q.device)[None, :] < length[:, None]
        lg = torch.where(msk[:, None, None, :], lg,
                         torch.full((), NEG, device=q.device))
    w = torch.softmax(lg, dim=-1).to(v.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, v)
    return out.reshape(b, hq, d)
