"""Sparse-matrix containers and padded formats (COO, CSR, ELL, SELL-C-σ):
the port's copy of ``repro/sparse/formats.py``, numpy only, giving the same
arrays.

Host-side data layer for the CG evaluation (paper §V-C): numpy only, so the
port keeps it without importing the reference. The CUDA kernels consume the
*flattened arrays* of these containers (``kernels/spmv_ell.py``,
``kernels/spmv_sell.py``, ``kernels/cg_fused.py``).

Why two padded formats
----------------------
The paper's CG uses Merrill & Garland's merge-based CSR SpMV, which
load-balances rows with a per-thread binary search over the merge path.
The reference replaced it with static padded formats that do the balancing
at data-prep time, and the port keeps them so both packages run on the
same arrays:

* **ELL** pads every row to the *global* max nnz ``K`` — fine for
  banded/regular matrices, costly for irregular ones (one hub row in a
  power-law graph pads the whole matrix to its degree).
* **SELL-C-σ** (Kreutzer et al., SIAM J. Sci. Comput. 36(5), 2014) sorts
  rows by nnz inside windows of ``σ``, cuts the sorted rows into slices
  of ``C``, and pads each slice only to *its own* max ``K_s``. Storage
  inside a slice is slot-major ("column-major"): element ``(r, j)`` of a
  slice lives at ``offset + j*C + r``, so neighbouring threads of a kernel
  read neighbouring addresses.

``PaddingReport`` quantifies the choice (fill ratio, bytes vs CSR) and
``choose_format`` picks per matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


# -- padding accounting -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PaddingReport:
    """How much a padded format costs vs the nnz it actually stores.

    ``stored`` counts padded slots (values); ``aux_bytes`` is per-format
    metadata (ELL: none; SELL: slice offset/len tables + row permutation).
    """

    format: str
    n_rows: int
    n_cols: int
    nnz: int
    stored: int
    value_bytes: int = 4
    index_bytes: int = 4
    aux_bytes: int = 0

    @property
    def fill_ratio(self) -> float:
        """Fraction of stored slots holding a true nonzero (1.0 = no padding)."""
        return self.nnz / self.stored if self.stored else 1.0

    @property
    def bytes(self) -> int:
        """Total footprint of the padded format."""
        return self.stored * (self.value_bytes + self.index_bytes) + self.aux_bytes

    @property
    def csr_bytes(self) -> int:
        """Footprint of plain CSR (values + indices + indptr)."""
        return (self.nnz * (self.value_bytes + self.index_bytes)
                + (self.n_rows + 1) * self.index_bytes)

    @property
    def bytes_vs_csr(self) -> float:
        """Padded bytes / CSR bytes — the padding blow-up factor."""
        return self.bytes / self.csr_bytes if self.csr_bytes else 1.0


# -- exact containers ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Coordinate triples. May hold duplicates (summed by ``to_csr``)."""

    rows: np.ndarray       # (nnz,) int
    cols: np.ndarray       # (nnz,) int
    data: np.ndarray       # (nnz,)
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @staticmethod
    def from_dense(a: np.ndarray) -> "COOMatrix":
        r, c = np.nonzero(a)
        return COOMatrix(r.astype(np.int64), c.astype(np.int64), a[r, c],
                         a.shape)

    def to_dense(self) -> np.ndarray:
        a = np.zeros(self.shape, self.data.dtype)
        np.add.at(a, (self.rows, self.cols), self.data)
        return a

    def to_csr(self) -> "CSRMatrix":
        """Sort by (row, col) and sum duplicate entries."""
        n, m = self.shape
        keys = self.rows.astype(np.int64) * m + self.cols.astype(np.int64)
        uniq, inv = np.unique(keys, return_inverse=True)
        data = np.bincount(inv, weights=self.data,
                           minlength=len(uniq)).astype(self.data.dtype)
        rows = (uniq // m).astype(np.int64)
        cols = (uniq % m).astype(np.int32)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        return CSRMatrix(indptr, cols, data, self.shape)


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Compressed sparse rows — the exact, conversion-hub format."""

    indptr: np.ndarray     # (n_rows + 1,) int64
    indices: np.ndarray    # (nnz,) int32, sorted within each row
    data: np.ndarray       # (nnz,)
    shape: tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @staticmethod
    def from_dense(a: np.ndarray) -> "CSRMatrix":
        return COOMatrix.from_dense(a).to_csr()

    def to_dense(self) -> np.ndarray:
        a = np.zeros(self.shape, self.data.dtype)
        a[np.repeat(np.arange(self.shape[0]), self.row_nnz), self.indices] = \
            self.data
        return a

    def to_coo(self) -> COOMatrix:
        rows = np.repeat(np.arange(self.shape[0], dtype=np.int64),
                         self.row_nnz)
        return COOMatrix(rows, self.indices.astype(np.int64), self.data,
                         self.shape)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Exact y = A @ x — the oracle the padded kernels are tested against."""
        rows = np.repeat(np.arange(self.shape[0]), self.row_nnz)
        y = np.bincount(rows, weights=self.data * x[self.indices],
                        minlength=self.shape[0])
        return y.astype(np.result_type(self.data.dtype, x.dtype))

    def is_symmetric(self, tol: float = 0.0) -> bool:
        coo = self.to_coo()
        t = COOMatrix(coo.cols, coo.rows, coo.data, self.shape).to_csr()
        return (np.array_equal(t.indptr, self.indptr)
                and np.array_equal(t.indices, self.indices)
                and bool(np.all(np.abs(t.data - self.data) <= tol)))

    # -- conversions to padded formats ---------------------------------------

    def to_ell(self, k: Optional[int] = None) -> "EllMatrix":
        """Pad every row to ``k`` slots (default: global max nnz).

        Raises ``ValueError`` naming the first offending row if an
        explicit ``k`` is smaller than some row's nnz — silent truncation
        would corrupt the operator.
        """
        n = self.n_rows
        lens = self.row_nnz
        kmax = int(lens.max()) if n and self.nnz else 0
        if k is None:
            k = max(kmax, 1)
        elif kmax > k:
            bad = int(np.argmax(lens > k))
            raise ValueError(
                f"ELL k={k} cannot hold row {bad} with {int(lens[bad])} "
                f"nonzeros (max row nnz is {kmax})")
        data = np.zeros((n, k), self.data.dtype)
        cols = np.zeros((n, k), np.int32)
        rowid = np.repeat(np.arange(n), lens)
        slot = np.arange(self.nnz) - np.repeat(self.indptr[:-1], lens)
        data[rowid, slot] = self.data
        cols[rowid, slot] = self.indices
        return EllMatrix(data, cols, self.shape[1], lens)

    def to_sell(self, c: int = 8, sigma: int = 64) -> "SellMatrix":
        """SELL-C-σ: sort rows by nnz within σ-windows, slice into chunks
        of C, pad each slice to its own max. ``sigma`` should be a
        multiple of ``c`` (σ = c degenerates to padded ELL per slice with
        no reordering; σ = n is full sorting)."""
        if c < 1 or sigma < 1:
            raise ValueError(f"need c >= 1 and sigma >= 1, got {c=} {sigma=}")
        n = self.n_rows
        n_pad = -(-max(n, 1) // c) * c
        lens = np.zeros(n_pad, np.int64)
        lens[:n] = self.row_nnz
        # σ-window descending-nnz sort; stable so equal rows keep CSR order
        perm = np.empty(n_pad, np.int64)
        for w0 in range(0, n_pad, sigma):
            w = np.arange(w0, min(w0 + sigma, n_pad))
            perm[w0:w0 + len(w)] = w[np.argsort(-lens[w], kind="stable")]
        n_slices = n_pad // c
        slice_k = np.maximum(lens[perm].reshape(n_slices, c).max(axis=1),
                             1).astype(np.int32)
        slice_offsets = np.zeros(n_slices, np.int64)
        np.cumsum(c * slice_k[:-1], out=slice_offsets[1:])
        total = int(slice_offsets[-1] + c * slice_k[-1])
        data = np.zeros(total, self.data.dtype)
        cols = np.zeros(total, np.int32)
        # position of each original row in the permuted padded order
        pos = np.empty(n_pad, np.int64)
        pos[perm] = np.arange(n_pad)
        rowid = np.repeat(np.arange(n), lens[:n])      # per-nnz original row
        slot = np.arange(self.nnz) - np.repeat(self.indptr[:-1], lens[:n])
        p = pos[rowid]
        flat = slice_offsets[p // c] + slot * c + p % c   # slot-major layout
        data[flat] = self.data
        cols[flat] = self.indices
        return SellMatrix(data, cols, slice_offsets.astype(np.int32),
                          slice_k, perm, self.shape, c, sigma,
                          lens[:n].copy())


# -- padded containers --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """ELL: (n_rows, K) value/column planes, rows zero-padded to K."""

    data: np.ndarray       # (n_rows, K)
    cols: np.ndarray       # (n_rows, K) int32, 0 in padding slots
    n_cols: int
    row_nnz: np.ndarray    # (n_rows,) true lengths (padding excluded)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data.shape[0], self.n_cols)

    @property
    def k(self) -> int:
        return int(self.data.shape[1])

    @property
    def nnz(self) -> int:
        return int(self.row_nnz.sum())

    def to_dense(self) -> np.ndarray:
        a = np.zeros(self.shape, self.data.dtype)
        n, k = self.data.shape
        valid = np.arange(k)[None, :] < self.row_nnz[:, None]
        r = np.repeat(np.arange(n), valid.sum(axis=1))
        np.add.at(a, (r, self.cols[valid]), self.data[valid])
        return a

    def padding_report(self) -> PaddingReport:
        return PaddingReport(
            "ell", self.shape[0], self.n_cols, self.nnz,
            int(self.data.size), self.data.dtype.itemsize,
            self.cols.dtype.itemsize)


@dataclasses.dataclass(frozen=True)
class SellMatrix:
    """SELL-C-σ with flat slot-major storage and a per-slice K table.

    ``perm[p]`` is the original (padded-space) row stored at permuted
    position ``p``; positions holding ``perm[p] >= n_rows`` are padding
    rows appended to fill the last chunk. Element ``(p % c)`` of slot
    ``j`` in slice ``s = p // c`` lives at ``slice_offsets[s] + j*c + p%c``.
    """

    data: np.ndarray           # (total_padded,)
    cols: np.ndarray           # (total_padded,) int32, 0 in padding slots
    slice_offsets: np.ndarray  # (n_slices,) int32 — flat start of each slice
    slice_k: np.ndarray        # (n_slices,) int32 — per-slice padded width
    perm: np.ndarray           # (n_padded_rows,) original row per position
    shape: tuple[int, int]
    c: int
    sigma: int
    row_nnz: np.ndarray        # (n_rows,) true lengths

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_slices(self) -> int:
        return int(self.slice_k.shape[0])

    @property
    def k_max(self) -> int:
        return int(self.slice_k.max()) if self.n_slices else 0

    @property
    def nnz(self) -> int:
        return int(self.row_nnz.sum())

    @property
    def stored(self) -> int:
        return int(self.data.shape[0])

    def row_positions(self) -> np.ndarray:
        """(n_rows,) permuted position of every original row — the gather
        that restores original row order after a SELL SpMV."""
        pos = np.empty(self.perm.shape[0], np.int64)
        pos[self.perm] = np.arange(self.perm.shape[0])
        return pos[: self.n_rows]

    def to_dense(self) -> np.ndarray:
        a = np.zeros(self.shape, self.data.dtype)
        for s in range(self.n_slices):
            k, off = int(self.slice_k[s]), int(self.slice_offsets[s])
            blk_d = self.data[off:off + self.c * k].reshape(k, self.c)
            blk_c = self.cols[off:off + self.c * k].reshape(k, self.c)
            for r in range(self.c):
                row = int(self.perm[s * self.c + r])
                if row >= self.n_rows:
                    continue
                ln = int(self.row_nnz[row])
                a[row, blk_c[:ln, r]] = blk_d[:ln, r]
        return a

    def padding_report(self) -> PaddingReport:
        aux = (self.slice_offsets.nbytes + self.slice_k.nbytes
               + 4 * self.perm.shape[0])        # perm shipped as int32
        return PaddingReport(
            "sell", self.n_rows, self.shape[1], self.nnz, self.stored,
            self.data.dtype.itemsize, self.cols.dtype.itemsize, aux)


def choose_format(csr: CSRMatrix, c: int = 8, sigma: int = 64,
                  threshold: float = 0.95):
    """Pick ELL vs SELL-C-σ for one matrix (the planner's data-layout leg).

    Returns ``(name, {"ell": PaddingReport, "sell": PaddingReport})``.
    SELL wins when it shrinks the footprint by more than ``1 - threshold``
    (its offset/permutation tables and gather-back step are only worth
    paying for when the padding saving is real — on banded/regular
    matrices both formats store the same slots and ELL's simpler layout
    wins ties).
    """
    ell = csr.to_ell().padding_report()
    sell = csr.to_sell(c=c, sigma=sigma).padding_report()
    name = "sell" if sell.bytes < threshold * ell.bytes else "ell"
    return name, {"ell": ell, "sell": sell}
