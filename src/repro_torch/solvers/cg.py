"""The CG data surface of ``repro/solvers/cg.py``: the dataset registry
(``DATASETS``/``load_matrix``/``load_dataset``/``load_sell``) and the
:class:`SellOperator` device container, on torch tensors.

The reference's deprecated ``run_*`` shims are not ported (ROADMAP); a CG
solve is::

    from repro_torch import CGProblem, execute, plan
    from repro_torch.solvers.cg import load_dataset, load_matrix, load_sell

    data, cols = load_dataset("poisson2d_small")            # on "cuda"
    problem = CGProblem.from_ell(data, cols, b, 100,
                                 matrix=load_matrix("poisson2d_small"))
    x, rr = execute(problem, plan(problem))

    op = load_sell("fem_band_8k")                           # SELL-C-σ
    problem = CGProblem.from_matvec(op.matvec, b, 100, matrix=op.matrix)
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.kernels import ops as kops
from repro_torch.sparse import CSRMatrix
from repro_torch.sparse.generate import REGISTRY, banded_spd, poisson2d

# name -> (constructor returning CSRMatrix, kwargs): the reference's legacy
# synthetic names, then every registry entry.
DATASETS = {
    "poisson_64": (poisson2d, {"side": 64}),
    "poisson_128": (poisson2d, {"side": 128}),
    "poisson_256": (poisson2d, {"side": 256}),
    "banded_4k": (banded_spd, {"n": 4096, "bands": 4}),
    "banded_16k": (banded_spd, {"n": 16384, "bands": 8}),
    "banded_64k": (banded_spd, {"n": 65536, "bands": 4}),
    **{name: (spec.builder, spec.kwargs)
       for name, spec in REGISTRY.items()},
}


def load_matrix(name: str) -> CSRMatrix:
    """Build one dataset as an exact CSR container (true nnz, row_nnz)."""
    fn, kw = DATASETS[name]
    return fn(**kw)


def load_dataset(name: str, device: _device.DeviceLike = None):
    """A dataset as ELL planes ``(data, cols)`` on ``device`` (default
    ``"cuda"``)."""
    ell = load_matrix(name).to_ell()
    dev = _device.resolve(device)
    return _device.as_domain(ell.data, dev), _device.as_domain(ell.cols, dev)


@dataclasses.dataclass(frozen=True)
class SellOperator:
    """Device SELL-C-σ operator: flat streams + slice tables + the
    row-order-restoring gather. ``matvec`` runs the SELL kernel
    (``kernels/spmv_sell.py``) and then the ``positions`` gather, a torch
    index as it is a jnp index in the reference."""

    data: torch.Tensor
    cols: torch.Tensor
    slice_offsets: torch.Tensor
    slice_k: torch.Tensor
    positions: torch.Tensor    # original row -> permuted padded position
    c: int
    k_max: int
    n_rows: int
    #: the source container (true nnz), so CGProblems rank A by the bytes
    #: it really streams, not the padded slots
    matrix: Any = None

    @staticmethod
    def from_matrix(sell, device: _device.DeviceLike = None
                    ) -> "SellOperator":
        """From a ``SellMatrix`` (of either package: duck-typed)."""
        dev = _device.resolve(device)

        def put(a):
            return _device.as_domain(np.asarray(a), dev)

        return SellOperator(
            put(sell.data), put(sell.cols), put(sell.slice_offsets),
            put(sell.slice_k), put(sell.row_positions()), int(sell.c),
            int(sell.k_max), int(sell.n_rows), matrix=sell)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y = kops.spmv_sell(self.data, self.cols, self.slice_offsets,
                           self.slice_k, x, c=self.c, k_max=self.k_max)
        return y[self.positions]


def load_sell(name: str, c: int = 32, sigma: int = 256,
              device: _device.DeviceLike = None) -> SellOperator:
    """A dataset as a device SELL-C-σ operator."""
    return SellOperator.from_matrix(
        load_matrix(name).to_sell(c=c, sigma=sigma), device)
