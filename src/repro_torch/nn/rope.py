"""Rotary position embeddings (RoPE), half-rotation convention: the port of
``repro/nn/rope.py``. ``positions`` may be a device tensor (the decode
step's position), so the step has no host value that changes per token."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions, head_dim: int, *, theta: float = 10000.0):
    """(cos, sin) of the rotation angles, (..., S, D/2) float32: the same for
    every layer, so a model computes them once per forward."""
    inv = rope_freqs(head_dim, theta, device=positions.device)  # (D/2,)
    ang = positions[..., None].float() * inv                    # (..., S, D/2)
    return torch.cos(ang), torch.sin(ang)


def rotate(x, cos, sin):
    """x: (..., S, H, D) or (..., S, D) rotated by ``rope_tables``' angles."""
    if x.dim() == cos.dim() + 1:                            # heads axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, *, theta: float = 10000.0):
    """x: (..., S, H, D) or (..., S, D); positions: broadcastable to (..., S)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta=theta))
