"""The port's own copy of ``icebin_tpu/coupler/multivec.py`` (numpy only);
it imports nothing of the reference package.

VectorMultivec: sparse multi-field vectors (the GCM-rank wire format).

Reference: ``slib/icebin/multivec.*`` [U] -- {index[], vals[nvar][]} sparse
vectors gathered over MPI from ModelE ranks to the coupler root (SURVEY.md
section 2).  In the TPU runtime dense sharded device arrays replace the MPI
gather (SURVEY.md section 2.11), but the sparse container remains the
boundary format for a Fortran GCM: each rank contributes only its owned
(i, j, ihc) cells, and the adapter densifies once per step.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = ["VectorMultivec", "concatenate"]


@dataclasses.dataclass
class VectorMultivec:
    """index: (n,) flat E/A indices; vals: (nvar, n)."""

    index: np.ndarray
    vals: np.ndarray

    def __post_init__(self):
        self.index = np.asarray(self.index, dtype=np.int64).reshape(-1)
        self.vals = np.atleast_2d(np.asarray(self.vals, dtype=np.float64))
        if self.vals.shape[1] != len(self.index):
            raise ValueError("vals/index length mismatch")

    @property
    def nvar(self) -> int:
        return self.vals.shape[0]

    def to_dense(self, n: int, fill: float = 0.0) -> np.ndarray:
        """Densify; duplicate indices ACCUMULATE (rank-boundary cells may be
        contributed by several ranks, reference semantics [U])."""
        out = np.full((self.nvar, n), fill, dtype=np.float64)
        seen = np.zeros(n, dtype=bool)
        seen[self.index] = True
        out[:, seen] = 0.0
        for k in range(self.nvar):
            np.add.at(out[k], self.index, self.vals[k])
        return out

    @classmethod
    def from_dense(cls, dense, mask=None) -> "VectorMultivec":
        dense = np.atleast_2d(np.asarray(dense))
        if mask is None:
            mask = np.isfinite(dense).all(axis=0) & (dense != 0).any(axis=0)
        idx = np.nonzero(np.asarray(mask).reshape(-1))[0]
        return cls(index=idx, vals=dense[:, idx])


def concatenate(vecs: List[VectorMultivec]) -> VectorMultivec:
    """Rank-gather replacement (reference ``concatenate`` over MPI [U])."""
    if not vecs:
        return VectorMultivec(index=np.zeros(0, np.int64),
                              vals=np.zeros((1, 0)))
    nvar = vecs[0].nvar
    if any(v.nvar != nvar for v in vecs):
        raise ValueError("mismatched nvar")
    return VectorMultivec(
        index=np.concatenate([v.index for v in vecs]),
        vals=np.concatenate([v.vals for v in vecs], axis=1))
