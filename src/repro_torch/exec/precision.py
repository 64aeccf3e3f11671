"""Precision as a Plan dimension: the port of ``repro/exec/precision.py``
(its "uniform" half).

``"uniform"`` reduces in the storage dtype with ``torch.dot``. ``"mixed"``
(a compensated or float64 dot in the loop tiers' step functions, and
``solve_refined``) is not ported yet: it comes with the Krylov slice
(ROADMAP, Queue 1). A Neumaier scan over n/256 block partials written in
torch would put thousands of launches into every iteration, so it waits
for a kernel of its own.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.exec.plan import PRECISIONS


def dot_for(precision: str) -> Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor]:
    """The reduction the Krylov step functions use under ``precision``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    if precision == "mixed":
        raise NotImplementedError(
            "precision='mixed' (the compensated dot) is not ported yet; it "
            "comes with the Krylov slice (ROADMAP, Queue 1)")
    return torch.dot
