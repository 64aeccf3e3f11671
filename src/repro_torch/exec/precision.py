"""Precision as a Plan dimension: the port of ``repro/exec/precision.py``.

The Krylov methods are memory-bound: the SpMV streams the matrix in the
storage dtype, and the dot products are where float32 rounding bites, since
the recurrences re-ground on ||r||^2-scale quantities whose accumulated
error grows as O(n eps). ``precision="mixed"`` keeps the SpMV in the
storage dtype and hardens only the dots:

* ``"uniform"`` reduces in the storage dtype with ``kernels.vdot.vdot``:
  ``torch.dot`` on the CPU, on the card ``csrc/vdot.cu``, whose order of
  additions depends on the length only, so one pair and a lane of a
  ``[B, n]`` batch (the batched tier, ``exec/batch.py``) give the same
  bits;
* ``"mixed"`` takes the reference's float64 branch (``jax_enable_x64``):
  both operands cast to float64, one float64 dot (``vdot`` again), one
  rounding back. The float32 products are exact in float64, so only the
  final rounding remains. The H100 has native float64, and this is three casts and one
  dot with no host read, so a CUDA graph holds it. The reference's other
  branch, a Neumaier scan over 256-element block partials, is not ported:
  in torch it would put n/256 sequential launches into every dot, and its
  float32 products already round before the compensated sum.

``solve_refined`` is iterative refinement over ``execute``: solve, form the
true residual, solve again for the correction. Each correction is the
problem's ``with_rhs`` copy, which shares its step functions, so a device
loop replays the first round's kept CUDA graph.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.exec.plan import PRECISIONS
from repro_torch.kernels.vdot import vdot


def compensated_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float64 dot rounded once to ``a``'s dtype (0-dim, or ``[B]`` for
    ``[B, n]`` stacks, on ``a``'s device); not a compensated sum: the name
    is the reference's, kept so the two packages name the mixed-precision
    dot alike."""
    return vdot(a.double(), b.double()).to(a.dtype)


def dot_for(precision: str) -> Callable[[torch.Tensor, torch.Tensor],
                                        torch.Tensor]:
    """The reduction the Krylov step functions use under ``precision``
    ('uniform' -> ``vdot``, 'mixed' -> ``compensated_vdot``); both take
    vectors or ``[B, n]`` stacks."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return compensated_vdot if precision == "mixed" else vdot


def solve_refined(problem, plan, *, rounds: int = 2):
    """Iterative refinement over ``execute``: ``rounds`` inner solves, each
    on the residual of the solution so far.

    The inner solver is whatever ``plan`` says (any single-device tier, any
    Krylov kind); each correction is the same problem with its right-hand
    side ``b`` replaced by the residual. Returns ``(x, rr)`` with ``rr``
    the true squared residual norm of the accumulated solution."""
    from repro_torch.exec.executor import execute
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    matvec = _operator_matvec(problem)
    b = problem.b
    x = torch.zeros_like(b)
    cur, r = problem, b
    for _ in range(rounds):
        dx, _ = execute(cur, plan)
        x = x + dx
        r = b - matvec(x)
        cur = problem.with_rhs(r)
    return x, torch.dot(r, r)


def _operator_matvec(problem) -> Callable[[torch.Tensor], torch.Tensor]:
    """The problem's operator apply (for the refinement residual): its
    matvec, else its ELL planes through ``kernels.ops.spmv``."""
    mv = getattr(problem, "matvec", None)
    if mv is not None:
        return mv
    data, cols = getattr(problem, "data", None), getattr(problem, "cols", None)
    if data is None:
        raise NotImplementedError(
            f"{type(problem).__name__} exposes neither matvec nor ELL "
            f"planes; solve_refined cannot form the true residual")
    from repro_torch.kernels import ops
    return functools.partial(ops.spmv, data, cols)
