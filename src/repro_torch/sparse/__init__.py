"""repro_torch.sparse — the sparse-matrix data layer of the CG slice: the
port's copy of ``repro.sparse`` (containers and conversions in
``formats``, the SuiteSparse-proxy registry in ``generate``). Host-side
numpy only; the CUDA kernels consume the flattened arrays.

Matrix Market IO (``io``) and nnz-balanced partitioning (``partition``)
are not ported yet (ROADMAP).
"""
from repro_torch.sparse.formats import (
    COOMatrix,
    CSRMatrix,
    EllMatrix,
    PaddingReport,
    SellMatrix,
    choose_format,
)
from repro_torch.sparse.generate import (
    PROXY_ONCHIP_BYTES,
    REGISTRY,
    DatasetSpec,
    generate,
    irregular_names,
    nonsymmetric_names,
    symmetric_names,
)

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "EllMatrix",
    "PaddingReport",
    "SellMatrix",
    "choose_format",
    "PROXY_ONCHIP_BYTES",
    "REGISTRY",
    "DatasetSpec",
    "generate",
    "irregular_names",
    "nonsymmetric_names",
    "symmetric_names",
]
