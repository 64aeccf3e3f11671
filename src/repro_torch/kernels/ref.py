"""Plain torch versions of the stencil kernels (the port's
``repro/kernels/ref.py``, stencil part).

They are what the CPU path runs and what ``chip_smoke.py`` holds each CUDA
kernel against on the card. No custom kernel, no scratch: torch ops only.
"""
from __future__ import annotations

from typing import Optional

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
