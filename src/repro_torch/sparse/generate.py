"""SuiteSparse-proxy dataset registry: the port's copy of
``repro/sparse/generate.py`` (numpy only, the same matrices bit for bit).

The paper's CG section (§V-C, Fig. 7/9) evaluates on SuiteSparse
matrices whose working sets straddle the on-chip capacity, splitting the
results into a small-matrix regime (everything cacheable) and a
large-matrix regime (partial residency). The repository holds no
SuiteSparse files, so the registry *generates* a structurally diverse
suite instead — one family per SuiteSparse structure class:

  * 2D/3D Poisson operators        — banded, constant row nnz (discretized PDE)
  * FEM-like variable-band         — band width varies smoothly along the rows
  * graph Laplacians               — random-regular (uniform degree) and
                                     preferential-attachment power-law
                                     (heavy-tailed degree: the case where
                                     ELL padding explodes and SELL-C-σ wins)
  * diagonally-shifted random      — unstructured scatter, variable row nnz
  * nonsymmetric operators         — for the Krylov slice (not CG)

The SPD generators return exact ``CSRMatrix`` operators that are symmetric
positive definite by construction (graph Laplacian + shift, or strict
diagonal dominance), so CG converges on every SPD entry.

The registry's sizes are small enough for the CPU tests; the regime split
is reproduced against ``PROXY_ONCHIP_BYTES``, the same proxy capacity the
reference plans them with. The H100 runs the generators at full size
(``poisson2d(side=1024)``, ``fem_variable_band(n=2**20)``) in
``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.sparse.formats import COOMatrix, CSRMatrix

# The reference's proxy on-chip capacity, 256 KiB: the registry's sizes
# straddle it (vectors alone overflow it for the 16k entries -> IMP regime).
PROXY_ONCHIP_BYTES = 256 * 1024


def _spd_from_pairs(n: int, ru: np.ndarray, cu: np.ndarray, vu: np.ndarray,
                    dtype, *, diag_boost: float = 0.5) -> CSRMatrix:
    """Symmetrize upper-triangle pairs (ru < cu) and add a dominant
    diagonal: diag_i = sum_j |a_ij| + diag_boost, which makes the matrix
    strictly diagonally dominant with positive diagonal => SPD."""
    rows = np.concatenate([ru, cu])
    cols = np.concatenate([cu, ru])
    vals = np.concatenate([vu, vu])
    absum = np.bincount(rows, weights=np.abs(vals), minlength=n)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, absum + diag_boost])
    return COOMatrix(rows, cols, vals.astype(dtype), (n, n)).to_csr()


def poisson2d(side: int, dtype=np.float32) -> CSRMatrix:
    """5-point 2D Poisson on a side x side grid (diag 4, neighbours -1)."""
    n = side * side
    idx = np.arange(n)
    r, c = idx // side, idx % side
    pairs = []
    right = idx[c < side - 1]
    pairs.append((right, right + 1))
    down = idx[r < side - 1]
    pairs.append((down, down + side))
    ru = np.concatenate([p[0] for p in pairs])
    cu = np.concatenate([p[1] for p in pairs])
    rows = np.concatenate([ru, cu, idx])
    cols = np.concatenate([cu, ru, idx])
    vals = np.concatenate([np.full(2 * len(ru), -1.0), np.full(n, 4.0)])
    return COOMatrix(rows, cols, vals.astype(dtype), (n, n)).to_csr()


def poisson3d(side: int, dtype=np.float32) -> CSRMatrix:
    """7-point 3D Poisson on a side^3 grid (diag 6, neighbours -1)."""
    n = side ** 3
    idx = np.arange(n)
    z = idx % side
    y = (idx // side) % side
    x = idx // (side * side)
    ru = np.concatenate([idx[z < side - 1], idx[y < side - 1],
                         idx[x < side - 1]])
    cu = np.concatenate([idx[z < side - 1] + 1,
                         idx[y < side - 1] + side,
                         idx[x < side - 1] + side * side])
    rows = np.concatenate([ru, cu, idx])
    cols = np.concatenate([cu, ru, idx])
    vals = np.concatenate([np.full(2 * len(ru), -1.0), np.full(n, 6.0)])
    return COOMatrix(rows, cols, vals.astype(dtype), (n, n)).to_csr()


def banded_spd(n: int, bands: int, seed: int = 0, dtype=np.float32) -> CSRMatrix:
    """Random SPD matrix with a constant band of ``bands`` off-diagonals
    per side (the legacy ``banded_*`` synthetic suite, now CSR-first)."""
    rng = np.random.default_rng(seed)
    ru, cu, vu = [], [], []
    for d in range(1, bands + 1):
        i = np.arange(n - d)
        ru.append(i)
        cu.append(i + d)
        vu.append(rng.standard_normal(n - d) * 0.1)
    return _spd_from_pairs(n, np.concatenate(ru), np.concatenate(cu),
                           np.concatenate(vu), dtype)


def fem_variable_band(n: int, min_band: int = 2, max_band: int = 16,
                      seed: int = 0, dtype=np.float32) -> CSRMatrix:
    """FEM-like operator whose bandwidth varies smoothly along the mesh
    (re-entrant corners / graded meshes give exactly this profile):
    row i couples to rows i±1..i±band(i), band(i) sweeping min..max over
    three periods. Variable row nnz, but locally correlated — the case
    where σ-window sorting alone (no global sort) recovers the padding."""
    rng = np.random.default_rng(seed)
    phase = np.sin(2.0 * np.pi * 3.0 * np.arange(n) / n)
    band = np.rint(min_band + (max_band - min_band) * 0.5 * (1.0 + phase))
    band = band.astype(np.int64)
    ru, cu = [], []
    for d in range(1, max_band + 1):
        i = np.arange(n - d)
        sel = i[band[i] >= d]          # couple i..i+d if row i's band allows
        ru.append(sel)
        cu.append(sel + d)
    ru = np.concatenate(ru)
    cu = np.concatenate(cu)
    vu = rng.standard_normal(len(ru)).astype(dtype) * 0.1
    return _spd_from_pairs(n, ru, cu, vu, dtype)


def graph_laplacian_regular(n: int, degree: int = 8, seed: int = 0,
                            dtype=np.float32) -> CSRMatrix:
    """Shifted Laplacian of a near-``degree``-regular random graph built
    as a union of ``degree`` random perfect matchings (duplicate edges
    and self-pairs merge, so a few rows dip below ``degree``). Uniform
    degree = the load-balanced end of the graph spectrum."""
    if n % 2:
        raise ValueError(f"n must be even for perfect matchings, got {n}")
    rng = np.random.default_rng(seed)
    ru, cu = [], []
    for _ in range(degree):
        p = rng.permutation(n)
        a, b = p[0::2], p[1::2]
        ru.append(np.minimum(a, b))
        cu.append(np.maximum(a, b))
    ru = np.concatenate(ru)
    cu = np.concatenate(cu)
    keep = ru != cu
    vu = np.full(keep.sum(), -1.0, dtype)
    return _spd_from_pairs(n, ru[keep], cu[keep], vu, dtype)


def graph_laplacian_powerlaw(n: int, m: int = 4, seed: int = 0,
                             dtype=np.float32) -> CSRMatrix:
    """Shifted Laplacian of a Barabási–Albert preferential-attachment
    graph: degree distribution ~ k^-3 with hub rows of degree O(sqrt(n)).
    The worst case for global-K ELL padding — every row pays the hub's
    width — and the motivating case for SELL-C-σ."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    repeated = list(range(m))          # node id repeated once per degree
    for v in range(m, n):
        targets: set[int] = set()
        while len(targets) < m:
            targets.add(int(repeated[rng.integers(len(repeated))]))
        for t in targets:
            src.append(v)
            dst.append(t)
            repeated.append(t)
        repeated.extend([v] * m)
    ru = np.minimum(src, dst)
    cu = np.maximum(src, dst)
    vu = np.full(len(ru), -1.0, dtype)
    return _spd_from_pairs(n, ru, cu, vu, dtype)


def convdiff2d(side: int, peclet: float = 1.5, shift: float = 0.5,
               dtype=np.float32) -> CSRMatrix:
    """2D convection–diffusion on a side x side grid, first-order upwind:
    the canonical *nonsymmetric* PDE operator (the convection term breaks
    the symmetry the Poisson suite has). Per grid direction the stencil is

        -(1 + pe) u_west + (2 + pe) u_center - u_east

    with cell Péclet number ``pe`` — upwinding loads the inflow neighbour,
    so A != A^T for any pe > 0. ``shift`` adds a mass term to the
    diagonal, making the matrix strictly diagonally dominant with positive
    diagonal: the symmetric part is then positive definite (field of
    values in the right half-plane), so GMRES/BiCGStab converge on every
    entry. Structure class: regular (5-point, constant interior row nnz).
    """
    n = side * side
    idx = np.arange(n)
    r, c = idx // side, idx % side
    # diagonal + the four couplings (row -> neighbour column), upwinded
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0 + 2.0 * peclet + shift)]
    west = idx[c > 0]
    rows.append(west); cols.append(west - 1)
    vals.append(np.full(len(west), -(1.0 + peclet)))
    east = idx[c < side - 1]
    rows.append(east); cols.append(east + 1)
    vals.append(np.full(len(east), -1.0))
    south = idx[r > 0]
    rows.append(south); cols.append(south - side)
    vals.append(np.full(len(south), -(1.0 + peclet)))
    north = idx[r < side - 1]
    rows.append(north); cols.append(north + side)
    vals.append(np.full(len(north), -1.0))
    return COOMatrix(np.concatenate(rows), np.concatenate(cols),
                     np.concatenate(vals).astype(dtype), (n, n)).to_csr()


def skew_shifted_random(n: int, row_nnz: int = 6, shift: float = 4.0,
                        seed: int = 0, dtype=np.float32) -> CSRMatrix:
    """Shifted skew-symmetric random sparse: A = shift*I + (R - R^T) with
    R a random scatter — maximally nonsymmetric (the symmetric part of
    the off-diagonal is exactly zero), purely imaginary off-diagonal
    spectrum shifted into the right half-plane. The symmetric part is
    ``shift*I`` (positive definite), so GMRES residuals contract at a
    known rate while CG's SPD assumption is violated as hard as possible
    — the adversarial entry for solver-applicability tests. Structure
    class: irregular (scatter collisions give variable row nnz)."""
    rng = np.random.default_rng(seed)
    ru = np.repeat(np.arange(n), row_nnz)
    cu = rng.integers(0, n, n * row_nnz)
    keep = ru < cu                     # strict upper triangle of R
    ru, cu = ru[keep], cu[keep]
    vu = rng.standard_normal(len(ru)).astype(dtype) * 0.2
    rows = np.concatenate([ru, cu, np.arange(n)])
    cols = np.concatenate([cu, ru, np.arange(n)])
    vals = np.concatenate([vu, -vu, np.full(n, shift)])   # R - R^T + shift*I
    return COOMatrix(rows, cols, vals.astype(dtype), (n, n)).to_csr()


def random_shifted(n: int, min_row_nnz: int = 4, max_row_nnz: int = 24,
                   seed: int = 0, dtype=np.float32) -> CSRMatrix:
    """Diagonally-shifted random sparse: each row scatters a uniformly
    random number of entries at uniformly random columns (then
    symmetrized). Unstructured AND variable-length — stresses both the
    gather and the padding."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(min_row_nnz, max_row_nnz + 1, n)
    ru = np.repeat(np.arange(n), counts)
    cu = rng.integers(0, n, counts.sum())
    keep = ru < cu                      # upper triangle only, rest mirrored
    ru, cu = ru[keep], cu[keep]
    vu = rng.standard_normal(len(ru)).astype(dtype) * 0.1
    return _spd_from_pairs(n, ru, cu, vu, dtype)


# -- the registry -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """One SuiteSparse-proxy entry: builder + structure class.

    ``structure``: "regular" (constant/near-constant row nnz — ELL is
    already tight), "banded" (constant band), or "irregular" (variable
    row nnz — the SELL-C-σ target class; the bench asserts SELL's fill
    ratio beats ELL's on every one of these).
    """

    name: str
    builder: Callable[..., CSRMatrix]
    kwargs: dict
    structure: str
    note: str = ""
    #: SPD entries (CG-applicable); False marks the nonsymmetric suite
    #: (BiCGStab/GMRES territory — CG's convergence theory does not apply)
    symmetric: bool = True

    def build(self) -> CSRMatrix:
        return self.builder(**self.kwargs)


REGISTRY: dict[str, DatasetSpec] = {
    s.name: s for s in (
        DatasetSpec("poisson2d_small", poisson2d, {"side": 48}, "regular",
                    "n=2304, 5-point stencil; fully cacheable regime"),
        DatasetSpec("poisson2d_16k", poisson2d, {"side": 128}, "regular",
                    "n=16384; vectors overflow the proxy capacity (IMP regime)"),
        DatasetSpec("poisson3d_16", poisson3d, {"side": 16}, "regular",
                    "n=4096, 7-point stencil"),
        DatasetSpec("fem_band_8k", fem_variable_band,
                    {"n": 8192, "min_band": 2, "max_band": 16}, "irregular",
                    "smoothly varying bandwidth 2..16"),
        DatasetSpec("graph_regular_4k", graph_laplacian_regular,
                    {"n": 4096, "degree": 8}, "regular",
                    "random-regular Laplacian: uniform degree"),
        DatasetSpec("graph_powerlaw_8k", graph_laplacian_powerlaw,
                    {"n": 8192, "m": 4}, "irregular",
                    "scale-free Laplacian: hub rows blow up ELL's global K"),
        DatasetSpec("rand_shift_16k", random_shifted,
                    {"n": 16384, "min_row_nnz": 4, "max_row_nnz": 24},
                    "irregular",
                    "unstructured scatter, row nnz uniform in 4..24"),
        # -- nonsymmetric suite (BiCGStab/GMRES; straddles the proxy capacity
        #    the same way the SPD entries do: _small cacheable, _16k IMP) --
        DatasetSpec("convdiff_small", convdiff2d, {"side": 48}, "regular",
                    "n=2304 upwind convection-diffusion; cacheable regime",
                    symmetric=False),
        DatasetSpec("convdiff_16k", convdiff2d, {"side": 128}, "regular",
                    "n=16384; vectors overflow the proxy capacity (IMP regime)",
                    symmetric=False),
        DatasetSpec("skew_shift_8k", skew_shifted_random,
                    {"n": 8192, "row_nnz": 6}, "irregular",
                    "shifted skew-symmetric scatter: zero symmetric "
                    "off-diagonal part", symmetric=False),
    )
}


def generate(name: str) -> CSRMatrix:
    """Build one registry dataset (deterministic: seeds are in kwargs)."""
    if name not in REGISTRY:
        raise KeyError(f"unknown dataset {name!r}; registry has "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[name].build()


def irregular_names() -> list[str]:
    return [n for n, s in REGISTRY.items() if s.structure == "irregular"]


def symmetric_names() -> list[str]:
    return [n for n, s in REGISTRY.items() if s.symmetric]


def nonsymmetric_names() -> list[str]:
    return [n for n, s in REGISTRY.items() if not s.symmetric]
