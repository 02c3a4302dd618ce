"""The port's own copy of ``icebin_tpu/utils/indexing.py``; it imports
nothing of the reference package.

Multi-dimensional <-> 1-D index maps and rank domains.

TPU-native re-design of the reference's index bookkeeping
(reference: ibmisc ``slib/ibmisc/indexing.hpp`` -- ``Indexing``, ``Domain`` [U];
see SURVEY.md section 2 "Indexing / Domain").  Unlike the reference (scalar C++
loops), everything here is vectorized over numpy/jax arrays so index translation
of millions of cells is a single fused op.

The reference supports both C (row-major) and Fortran (column-major) dimension
ordering because ModelE is Fortran: the ModelE atmosphere array is ``(im, jm)``
with ``i`` varying fastest.  We keep that capability: ``Indexing`` stores the
dimensions in *declaration order* plus a permutation giving storage-major order.
"""
from __future__ import annotations

import dataclasses
import numpy as np

__all__ = ["Indexing", "Domain"]


@dataclasses.dataclass(frozen=True)
class Indexing:
    """Maps tuples in an n-dim index space to/from flat 1-D indices.

    Parameters
    ----------
    shape:
        Extent of each dimension, in declaration order.
    base:
        Lower bound of each dimension (0 for C, often 1 for Fortran).
    major_to_minor:
        Permutation of ``range(ndim)``: dimension indices ordered from
        slowest-varying (major) to fastest-varying (minor).  Row-major (C)
        order for 2-D is ``(0, 1)``; column-major (Fortran) is ``(1, 0)``.
    names:
        Optional dimension names (e.g. ``("lon", "lat")``).
    """

    shape: tuple
    base: tuple = None
    major_to_minor: tuple = None
    names: tuple = None

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        object.__setattr__(self, "shape", shape)
        n = len(shape)
        base = tuple(int(b) for b in (self.base or (0,) * n))
        object.__setattr__(self, "base", base)
        m2m = tuple(int(i) for i in (self.major_to_minor or range(n)))
        if sorted(m2m) != list(range(n)):
            raise ValueError(f"major_to_minor {m2m} is not a permutation")
        object.__setattr__(self, "major_to_minor", m2m)
        names = tuple(self.names) if self.names else tuple(f"d{i}" for i in range(n))
        object.__setattr__(self, "names", names)
        # Stride (in flat index units) of each declared dimension.
        strides = [0] * n
        s = 1
        for d in reversed(m2m):  # minor -> major
            strides[d] = s
            s *= shape[d]
        object.__setattr__(self, "_strides", tuple(strides))

    @classmethod
    def c_order(cls, shape, names=None):
        return cls(shape=tuple(shape), names=names)

    @classmethod
    def f_order(cls, shape, names=None):
        """Fortran storage order: first declared dim varies fastest."""
        n = len(shape)
        return cls(shape=tuple(shape), major_to_minor=tuple(reversed(range(n))),
                   names=names)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def strides(self) -> tuple:
        return self._strides

    def tuple_to_index(self, *idx):
        """Vectorized tuple -> flat index.  Accepts scalars or arrays."""
        if len(idx) == 1 and isinstance(idx[0], (tuple, list)):
            idx = tuple(idx[0])
        if len(idx) != self.ndim:
            raise ValueError(f"expected {self.ndim} indices, got {len(idx)}")
        out = 0
        for d, (i, b, st) in enumerate(zip(idx, self.base, self._strides)):
            out = out + (np.asarray(i) - b) * st
        return out

    def index_to_tuple(self, flat):
        """Vectorized flat index -> tuple of per-dim indices."""
        flat = np.asarray(flat)
        out = [None] * self.ndim
        rem = flat
        for d in self.major_to_minor:
            st = self._strides[d]
            q = rem // st
            rem = rem - q * st
            out[d] = q + self.base[d]
        return tuple(out)

    def __len__(self):
        return self.size


@dataclasses.dataclass(frozen=True)
class Domain:
    """A per-shard rectangular subdomain of an ``Indexing`` space.

    Reference: ``ibmisc::Domain`` [U] describes each MPI rank's owned
    (i, j) block.  Here a ``Domain`` describes the block of the global index
    space owned by one TPU device in a 1-D/2-D device mesh (e.g.
    ``coupler.sharded.MeshIceSheetCoupler.local_domains``).
    """

    low: tuple   # inclusive, per declared dim
    high: tuple  # exclusive, per declared dim

    def in_domain(self, *idx):
        ok = True
        for i, lo, hi in zip(idx, self.low, self.high):
            i = np.asarray(i)
            ok = ok & (i >= lo) & (i < hi)
        return ok

    @property
    def shape(self):
        return tuple(h - l for l, h in zip(self.low, self.high))

    @property
    def size(self):
        return int(np.prod(self.shape))
