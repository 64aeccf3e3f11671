"""GQA flash-decode on Hopper: the port of ``repro/kernels/decode_attn.py``.

``decode_attention(q, k, v, length=)`` attends one query token per sequence
to its KV cache: q (B, Hq, D), k/v (B, S, Hkv, D), ``length`` an optional
(B,) int32 tensor of valid prefixes (the rest masked) -> (B, Hq, D). It
computes the function of ``ref.decode_attention``; the reference's TPU
kernel is its ``length=None`` case and needs ``S % block_s == 0``, which the
CUDA kernels do not (they take no block size: ``splits_for`` picks the KV
splits from the shapes). A CPU tensor runs the plain version; a CUDA tensor
launches one of the two kernels of ``csrc/decode_attn.cu``, as
``kernel_for`` names it from dtype and shape before the launch, or raises —
there is no fallback:

- ``"tensor_cores"``: bf16 with D % 16 == 0, k and v 16-byte aligned — the
  logits and the value product on ``mma.sync``, fed by TMA into a ring of
  ``mma_layout(D)`` stages of 64-position K/V tiles;
- ``"cuda_cores"``: float32, and bf16 of other head dims or alignment.

The launch takes no host value that changes from one decode step to the
next (``length`` stays on the card), so the model's decode step can be
captured into a CUDA graph. The wrapper counts its launches in
``decode_attention.launches``, and each kernel's apart in ``tc_launches``
and ``cc_launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

#: Threads of a CUDA-core CTA, hence the positions one pass of it covers
#: (``DA_THREADS`` in ``csrc/decode_attn.cu``).
THREADS = 256
#: Largest query group Hq / Hkv and head dim the kernels take.
MAX_GROUP = 16
MAX_HEAD_DIM = 256
#: Positions of one K/V tile of the tensor-core kernel (``DT_TILE``).
TILE = 64
#: Shared memory the tensor-core kernel may take: one CTA's opt-in maximum on
#: an H100 (232,448 B), or, for D <= 128, what lets two CTAs share a SM.
SMEM_OPTIN = 232448
SMEM_TWO_A_SM = 112640
MAX_STAGES = 8          # DT_MAX_STAGES

_SMS: dict[int, int] = {}


def kernel_for(dtype: torch.dtype, group: int, dim: int,
               aligned: bool = True) -> str:
    """Which kernel a CUDA call launches: ``"tensor_cores"`` for bf16 with
    ``dim % 16 == 0``, ``dim <= 256``, ``group <= 16`` and k, v 16-byte
    ``aligned``; else ``"cuda_cores"`` (float32 stays there: TF32 products
    would miss its tolerance)."""
    if (dtype == torch.bfloat16 and dim % 16 == 0 and dim <= MAX_HEAD_DIM
            and group <= MAX_GROUP and aligned):
        return "tensor_cores"
    return "cuda_cores"


def mma_layout(dim: int) -> tuple[int, int]:
    """``(stages, shared memory bytes)`` of the tensor-core kernel at head
    dim ``dim`` (``mma_smem_bytes`` in the source): mbarriers, 16 query rows
    padded to 2D + 16 bytes, 1024 bytes to align the ring, then the most
    stages of a 64-position K and V tile that fit two CTAs a SM up to
    D = 128 and one above (a stage at D = 256 is 64 KB), at most eight, and
    4 or 8 where more than three fit (consumer warp w reads stages w and
    w + 4, so the warps share the tiles evenly)."""
    head = 128 + 16 * (2 * dim + 16) + 1024
    stage = 2 * TILE * 2 * dim
    budget = SMEM_TWO_A_SM if dim <= 128 else SMEM_OPTIN
    stages = min(MAX_STAGES, (budget - head) // stage)
    if stages > 4:
        stages -= stages % 4
    return stages, head + stages * stage


def splits_for(batch: int, kv_heads: int, seq: int, sms: int, *,
               kernel: str = "cuda_cores") -> tuple[int, int]:
    """``(splits, positions per split)`` of the KV sequence, none empty,
    from shapes only, so a captured decode step keeps its launch.

    - ``"tensor_cores"``: in 64-position tiles, as many splits as give one
      CTA a SM (rounded down), at most one a tile: B = 8, Hkv = 2, S = 160
      gives 3 splits (48 CTAs), S = 32768 gives 8 of 4096 positions (128
      CTAs; two CTAs a SM, 16 splits, ran slower on an H100 SXM).
    - ``"cuda_cores"``: enough CTAs for two a SM (rounded up) when the
      sequence is long enough, each split a multiple of ``THREADS``
      positions."""
    if kernel == "tensor_cores":
        tiles = -(-seq // TILE)
        want = max(1, min(tiles, sms // (batch * kv_heads)))
        per = -(-tiles // want) * TILE
        return -(-seq // per), per
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
    kind = kernel_for(q.dtype, hq // hkv, dim, aligned=(
        k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0))
    splits, per = splits_for(bsz, hkv, s, sms, kernel=kind)
    part = (torch.empty(bsz * hq * splits * (dim + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    lib = _build.load("decode_attn")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if length is None else length.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), bsz, s, hq, hkv, dim,
            splits, per)
    with _build.on_device(q):
        if kind == "tensor_cores":
            err = lib.decode_attn_mma_launch(*args, mma_layout(dim)[0],
                                             _build.stream())
        else:
            err = lib.decode_attn_launch(*args, int(q.dtype == torch.bfloat16),
                                         _build.stream())
    _build.check(err, "decode_attn_mma_launch" if kind == "tensor_cores"
                 else "decode_attn_launch")
    if kind == "tensor_cores":
        decode_attention.tc_launches += 1
    else:
        decode_attention.cc_launches += 1
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.tc_launches = 0
decode_attention.cc_launches = 0
