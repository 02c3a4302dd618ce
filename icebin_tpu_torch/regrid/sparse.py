"""The port's own copy of ``icebin_tpu/regrid/sparse.py``; it imports
nothing of the reference package.  One addition:
``WeightedMatrix.from_sorted`` takes COO that is already ``coo_dedup``'s
output (regeneration on the card deduplicates there) without sorting it
again.

Weighted sparse matrices: the {wM, M, Mw} abstraction, TPU-native.

Reference: ibmisc ``linear::Weighted_Eigen`` = dest-weight vector ``wM``, an
Eigen sparse matrix ``M`` (unscaled, 'integral' form), and src-weight vector
``Mw`` (reference: ``ibmisc:slib/ibmisc/linear/*`` [U]; SURVEY.md section 2
"linear::Weighted").  Re-design decisions:

* Storage is plain COO (row, col, val) in f64 numpy on the host -- matrix
  *construction* is host-side and exact; matrix *application* converts once
  to a device-resident, row-sorted form and runs as a jitted segment-sum or a
  Pallas ELL kernel (``icebin_tpu.ops.spmv``).
* ``wM`` is ALWAYS the row sums and ``Mw`` ALWAYS the column sums of M.  The
  reference maintains these by construction too; making it an invariant here
  means every conservation identity (sum_dest (Mf)_dest == sum_src f_src *
  Mw_src) holds for *any* composition, mechanically.
* ``SparseSet`` (dense<->sparse index translation, reference ``SparseSet``
  [U]) appears here as ``dense_subset``: matrices over huge conceptual index
  spaces are compacted to their realized rows/cols for device residency.
"""
from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["WeightedMatrix", "SparseSet", "coo_dedup"]


def coo_dedup(rows, cols, vals, shape):
    """Sum duplicate (row, col) entries; returns sorted-by-row COO.

    Reference equivalent: spsparse accumulator consolidation
    (``ibmisc:slib/spsparse`` TupleList sum-duplicates [U]).  Sort is stable,
    so accumulation order -- and therefore f64 rounding -- is deterministic
    (SURVEY.md section 5.2 'deterministic scatter-add order').
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    key = rows * shape[1] + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    uniq, inv = np.unique(key, return_inverse=True)
    out_vals = np.zeros(len(uniq), dtype=np.float64)
    np.add.at(out_vals, inv, vals)
    out_rows = uniq // shape[1]
    out_cols = uniq % shape[1]
    return out_rows, out_cols, out_vals


class SparseSet:
    """Bidirectional map between a sparse subset of a huge conceptual index
    space and packed dense indices 0..n-1 (reference: ``SparseSet`` [U])."""

    def __init__(self, sparse_indices):
        self.sparse = np.unique(np.asarray(sparse_indices, dtype=np.int64))

    def __len__(self):
        return len(self.sparse)

    def to_dense(self, sparse_idx):
        d = np.searchsorted(self.sparse, sparse_idx)
        ok = (d < len(self.sparse)) & (self.sparse[np.minimum(d, len(self.sparse) - 1)] == sparse_idx)
        if not np.all(ok):
            raise KeyError("index not in SparseSet")
        return d

    def to_sparse(self, dense_idx):
        return self.sparse[dense_idx]


@dataclasses.dataclass
class WeightedMatrix:
    """Unscaled sparse regrid matrix with destination/source weights.

    ``M`` maps integrals: (M f)_r = sum_c M[r,c] f_c where f is piecewise
    constant means on source cells and M entries are (possibly corrected)
    overlap areas.  ``apply(f, scale=True)`` divides by ``wM`` to produce
    destination means.  Conservation: sum_r apply(f)_r * wM_r ==
    sum_c f_c * Mw_c, exactly (f64 summation of identical terms).
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    shape: tuple
    # Optional dense conceptual extents when rows/cols are already dense.

    def __post_init__(self):
        r, c, v = coo_dedup(self.rows, self.cols, self.vals, self.shape)
        self.rows, self.cols, self.vals = r, c, v
        self._wM = None
        self._Mw = None

    @property
    def nnz(self) -> int:
        return len(self.vals)

    @property
    def wM(self) -> np.ndarray:
        """Destination weights = row sums."""
        if self._wM is None:
            self._wM = np.bincount(self.rows, weights=self.vals,
                                   minlength=self.shape[0])
        return self._wM

    @property
    def Mw(self) -> np.ndarray:
        """Source weights = column sums."""
        if self._Mw is None:
            self._Mw = np.bincount(self.cols, weights=self.vals,
                                   minlength=self.shape[1])
        return self._Mw

    # -- host (oracle) apply ----------------------------------------------

    def apply(self, f, scale: bool = True, fill: float = np.nan):
        """Host f64 apply; f: (ncol,) or (nvar, ncol). Dest cells with zero
        weight get ``fill``.  This is the scipy-level oracle the TPU apply
        kernels are tested against (SURVEY.md section 7 stage 2)."""
        f = np.asarray(f, dtype=np.float64)
        single = f.ndim == 1
        fv = f[None, :] if single else f
        out = np.zeros((fv.shape[0], self.shape[0]), dtype=np.float64)
        contrib = self.vals[None, :] * fv[:, self.cols]
        for k in range(fv.shape[0]):
            out[k] = np.bincount(self.rows, weights=contrib[k],
                                 minlength=self.shape[0])
        if scale:
            w = self.wM
            with np.errstate(invalid="ignore", divide="ignore"):
                out = np.where(w[None, :] != 0, out / np.where(w != 0, w, 1.0),
                               fill)
        return out[0] if single else out

    def transpose(self) -> "WeightedMatrix":
        return WeightedMatrix(rows=self.cols.copy(), cols=self.rows.copy(),
                              vals=self.vals.copy(),
                              shape=(self.shape[1], self.shape[0]))

    def scale_rows(self, s) -> "WeightedMatrix":
        """Return a copy with rows r multiplied by s[r]."""
        return WeightedMatrix(rows=self.rows, cols=self.cols,
                              vals=self.vals * np.asarray(s)[self.rows],
                              shape=self.shape)

    def scale_cols(self, s) -> "WeightedMatrix":
        return WeightedMatrix(rows=self.rows, cols=self.cols,
                              vals=self.vals * np.asarray(s)[self.cols],
                              shape=self.shape)

    def to_scipy(self):
        from scipy.sparse import coo_matrix
        return coo_matrix((self.vals, (self.rows, self.cols)), shape=self.shape)

    @classmethod
    def from_sorted(cls, rows, cols, vals, shape) -> "WeightedMatrix":
        """The matrix of COO that is ``coo_dedup``'s output already:
        distinct (row, col) entries sorted by row, then column.  Taken as
        given, with no second dedup."""
        m = cls.__new__(cls)
        m.rows = np.asarray(rows, dtype=np.int64)
        m.cols = np.asarray(cols, dtype=np.int64)
        m.vals = np.asarray(vals, dtype=np.float64)
        m.shape = tuple(int(n) for n in shape)
        m._wM = None
        m._Mw = None
        return m

    @classmethod
    def from_scipy(cls, m) -> "WeightedMatrix":
        m = m.tocoo()
        return cls(rows=m.row.astype(np.int64), cols=m.col.astype(np.int64),
                   vals=m.data.astype(np.float64), shape=m.shape)

    def row_subset(self) -> SparseSet:
        return SparseSet(self.rows)

    def col_subset(self) -> SparseSet:
        return SparseSet(self.cols)
