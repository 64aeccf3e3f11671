"""Stencil specifications (Table III of the paper) and their plain torch
step, the port's copy of ``repro/kernels/common.py``.

A ``StencilSpec`` is a pure description — offsets and weights — consumed
by the CUDA kernels (``stencil2d.py``), the plain torch versions
(``ref.py``) and the executor (``repro_torch.exec``).

Boundary rule, as in the reference: the outermost ``radius`` cells of the
domain on every axis are Dirichlet (frozen); only the interior is updated.
The terms of one update are summed in ``offsets`` order, each one a
float32 product ``w * x`` rounded before the add, which is the order the
CUDA kernels follow so the two agree bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    name: str
    ndim: int
    offsets: tuple[tuple[int, ...], ...]
    weights: tuple[float, ...]

    def __post_init__(self):
        if len(self.offsets) != len(self.weights):
            raise ValueError("offsets and weights differ in length")
        if not all(len(o) == self.ndim for o in self.offsets):
            raise ValueError(f"every offset must have {self.ndim} entries")

    @functools.cached_property
    def radius(self) -> int:
        return max(max(abs(c) for c in o) for o in self.offsets)

    @functools.cached_property
    def npoints(self) -> int:
        return len(self.offsets)

    @property
    def flops_per_cell(self) -> int:
        # one multiply + one add per point (paper Table III convention)
        return 2 * self.npoints

    # -- plain torch compute --------------------------------------------------

    def _interior_sum(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Weighted sum over the offsets for rows [lo, hi), restricted to the
        interior of the non-leading axes; ``x`` holds rows
        [lo - radius, hi + radius)."""
        r = self.radius
        acc = None
        for off, w in zip(self.offsets, self.weights):
            d0, rest = off[0], off[1:]
            idx = [slice(lo + d0, hi + d0)]
            for ax, d in enumerate(rest):
                n = x.shape[1 + ax]
                idx.append(slice(r + d, n - r + d))
            term = x[tuple(idx)] * w
            acc = term if acc is None else acc + term
        return acc

    def _rest_interior(self, x: torch.Tensor) -> tuple[slice, ...]:
        r = self.radius
        return tuple(slice(r, x.shape[1 + ax] - r)
                     for ax in range(self.ndim - 1))

    def apply_rows(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """Updated values of leading-axis rows [lo, hi) of ``x`` (a new
        tensor). ``x`` must contain rows [lo - radius, hi + radius);
        non-leading-axis borders are copied through from ``x``."""
        out = x[lo:hi].clone()
        out[(slice(None),) + self._rest_interior(x)] = \
            self._interior_sum(x, lo, hi)
        return out

    def apply(self, x: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One full time step: interior updated, global border frozen.
        Writes into ``out`` when given (it must not alias ``x``)."""
        r = self.radius
        H = x.shape[0]
        out = x.clone() if out is None else out.copy_(x)
        out[(slice(r, H - r),) + self._rest_interior(x)] = \
            self._interior_sum(x, r, H - r)
        return out


def _star(ndim: int, radius: int) -> list[tuple[int, ...]]:
    offs = [tuple([0] * ndim)]
    for ax in range(ndim):
        for d in range(1, radius + 1):
            for s in (-d, d):
                o = [0] * ndim
                o[ax] = s
                offs.append(tuple(o))
    return offs


def _box(ndim: int, radius: int) -> list[tuple[int, ...]]:
    return list(itertools.product(range(-radius, radius + 1), repeat=ndim))


def _poisson3d() -> list[tuple[int, ...]]:
    """Classic 19-point 3D Poisson stencil: 3x3x3 cube minus the 8 corners."""
    return [o for o in _box(3, 1) if sum(abs(c) for c in o) <= 2]


def _3d17pt() -> list[tuple[int, ...]]:
    """The reference's fixed symmetric 17-point stencil: r=1 star (7) +
    4 xy-diagonals + r=2 axis points (6)."""
    offs = _star(3, 1)
    offs += [(0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1)]
    offs += [(2, 0, 0), (-2, 0, 0), (0, 2, 0), (0, -2, 0), (0, 0, 2), (0, 0, -2)]
    return offs


def _mk(name: str, ndim: int, offsets: Sequence[tuple[int, ...]]) -> StencilSpec:
    n = len(offsets)
    # Jacobi-style averaging weights: stable over thousands of steps.
    w = tuple(1.0 / n for _ in offsets)
    return StencilSpec(name, ndim, tuple(offsets), w)


# Table III of the paper: benchmark(stencil order, flops/cell).
BENCHMARKS: dict[str, StencilSpec] = {
    "2d5pt": _mk("2d5pt", 2, _star(2, 1)),
    "2ds9pt": _mk("2ds9pt", 2, _star(2, 2)),
    "2d13pt": _mk("2d13pt", 2, _star(2, 3)),
    "2d17pt": _mk("2d17pt", 2, _star(2, 4)),
    "2d21pt": _mk("2d21pt", 2, _star(2, 5)),
    "2ds25pt": _mk("2ds25pt", 2, _star(2, 6)),
    "2d9pt": _mk("2d9pt", 2, _box(2, 1)),
    "2d25pt": _mk("2d25pt", 2, _box(2, 2)),
    "3d7pt": _mk("3d7pt", 3, _star(3, 1)),
    "3d13pt": _mk("3d13pt", 3, _star(3, 2)),
    "3d17pt": _mk("3d17pt", 3, _3d17pt()),
    "3d27pt": _mk("3d27pt", 3, _box(3, 1)),
    "poisson": _mk("poisson", 3, _poisson3d()),
}


def get_spec(name: str) -> StencilSpec:
    return BENCHMARKS[name]
