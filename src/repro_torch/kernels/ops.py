"""Public keyword wrappers for the stencil kernels, as in
``repro/kernels/ops.py``.

Each call dispatches on the tensor's device (``stencil2d.py``): a CUDA
tensor launches the hand-written kernel or raises, a CPU tensor runs the
plain torch version. ``launch_counts``/``reset_launch_counts`` read and
zero the kernels' launch counters.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import stencil2d as _s2d
from repro_torch.kernels.common import StencilSpec

#: kernel name -> the wrapper that carries its launch counter
KERNELS = {
    "stencil_perks": _s2d.stencil_perks,
    "stencil_resident": _s2d.stencil_resident,
    "stencil_baseline_step": _s2d.stencil_baseline_step,
}


def stencil_resident(x: torch.Tensor, *, spec: StencilSpec,
                     steps: int) -> torch.Tensor:
    """Small-domain PERKS stencil (whole domain in shared memory)."""
    return _s2d.stencil_resident(x, spec, steps=steps)


def stencil_perks(x: torch.Tensor, *, spec: StencilSpec, steps: int,
                  cached_rows: int, sub_rows: int = 128,
                  fuse_steps: int = 1) -> torch.Tensor:
    """Large-domain PERKS stencil (leading rows cached, rest streamed)."""
    return _s2d.stencil_perks(x, spec, steps=steps, cached_rows=cached_rows,
                              sub_rows=sub_rows, fuse_steps=fuse_steps)


def stencil_baseline_step(x: torch.Tensor, *, spec: StencilSpec,
                          sub_rows: int = 128,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One non-persistent stencil step (the loop tiers' kernel)."""
    return _s2d.stencil_baseline_step(x, spec, sub_rows=sub_rows, out=out)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
