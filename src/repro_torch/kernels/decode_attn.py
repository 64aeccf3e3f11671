"""GQA flash-decode on Hopper: the port of ``repro/kernels/decode_attn.py``.

``decode_attention(q, k, v, length=)`` attends one query token per sequence
to its KV cache: q (B, Hq, D), k/v (B, S, Hkv, D), ``length`` an optional
(B,) int32 tensor of valid prefixes (the rest masked) -> (B, Hq, D). It
computes the function of ``ref.decode_attention``; the reference's TPU
kernel is its ``length=None`` case and needs ``S % block_s == 0``, which the
CUDA kernel does not (it takes no block size: ``splits_for`` picks its KV
splits from the shapes). A CPU tensor runs the plain version; a CUDA tensor launches
``csrc/decode_attn.cu`` or raises — there is no fallback. The launch takes
no host value that changes from one decode step to the next (``length``
stays on the card), so the model's decode step can be captured into a CUDA
graph. The wrapper counts its launches in ``decode_attention.launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

#: Threads of a CTA, hence the positions one pass of a CTA covers
#: (``DA_THREADS`` in ``csrc/decode_attn.cu``).
THREADS = 256
#: Largest query group Hq / Hkv and head dim the kernel takes.
MAX_GROUP = 16
MAX_HEAD_DIM = 256

_SMS: dict[int, int] = {}


def splits_for(batch: int, kv_heads: int, seq: int, sms: int
               ) -> tuple[int, int]:
    """``(splits, positions per split)`` of the KV sequence: enough CTAs for
    two a SM when the sequence is long enough, each split a multiple of
    ``THREADS`` positions and none empty. Depends on shapes only, so a
    captured decode step keeps its launch."""
    want = max(1, min(-(-seq // THREADS), -(-2 * sms // (batch * kv_heads))))
    per = -(-seq // want)
    per = -(-per // THREADS) * THREADS
    return -(-seq // per), per


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Hq, D); k, v (B, S, Hkv, D) -> (B, Hq, D)."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention: q must be (B, Hq, D) and k, v "
                         f"(B, S, Hkv, D) alike, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bsz, hq, dim = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != bsz or k.shape[3] != dim or hq % hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} (B and D alike, Hq % Hkv == 0)")
    if length is not None and tuple(length.shape) != (bsz,):
        raise ValueError(f"decode_attention: length must be (B,), got "
                         f"{tuple(length.shape)}")
    if _build.is_cpu(q, "decode_attention"):
        return ref.decode_attention(q, k, v, length=length)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: the CUDA kernel takes float32 or "
                        f"bf16 q, k, v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if hq // hkv > MAX_GROUP or dim > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: the CUDA kernel takes Hq/Hkv <= "
                         f"{MAX_GROUP} and D <= {MAX_HEAD_DIM}, got "
                         f"{hq // hkv} and {dim}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention: the CUDA kernel takes contiguous "
                         "k and v")
    if any(t.device != q.device for t in (k, v)) or (
            length is not None and length.device != q.device):
        raise ValueError("decode_attention: every operand must lie on q's "
                         "device")
    if length is not None and length.dtype != torch.int32:
        raise TypeError(f"decode_attention: length must be int32, got "
                        f"{length.dtype}")
    q = q.contiguous()
    out = torch.empty_like(q)
    if bsz == 0 or hq == 0:
        return out
    if s == 0:
        raise ValueError("decode_attention: the cache is empty")
    dev = q.device.index if q.device.index is not None else \
        torch.cuda.current_device()
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    splits, per = splits_for(bsz, hkv, s, sms)
    part = (torch.empty(bsz * hq * splits * (dim + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    lib = _build.load("decode_attn")
    with _build.on_device(q):
        err = lib.decode_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if length is None else length.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), bsz, s, hq, hkv, dim,
            splits, per, int(q.dtype == torch.bfloat16), _build.stream())
    _build.check(err, "decode_attn_launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
