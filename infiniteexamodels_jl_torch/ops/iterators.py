"""Column-store iterators for SIMD families.

The reference builds ``Vector{NamedTuple}`` iterators (one named tuple per
support combination, InfiniteExaModels.jl/src/transform.jl:31,445).  The array-native
equivalent is a struct-of-arrays: a dict of equally-long numpy columns.  Rows
exist only conceptually; families vmap over the row axis.
"""
from __future__ import annotations

import numpy as np

from .expr import FieldRef, IdxAff


class DataSource:
    """Symbolic access point to iterator columns, used when writing templates:
    ``src.i`` / ``src['i']`` yields a reference usable either as a tensor
    index (integer column) or as a float value in the expression (mirrors
    ExaModels.DataSource, used at InfiniteExaModels.jl/src/transform.jl:453)."""

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return FieldRef(name)

    def __getitem__(self, name):
        return FieldRef(name)


SRC = DataSource()


class Iterator:
    """A table of named columns, all length ``n``.  Integer columns serve as
    tensor indices inside templates; float columns as per-row data."""

    def __init__(self, columns=None, n=None):
        self.columns = {}
        self.n = n
        if columns:
            for k, v in columns.items():
                self[k] = v
        if self.n is None:
            self.n = 0 if not self.columns else len(next(iter(self.columns.values())))

    def __setitem__(self, name, values):
        arr = np.asarray(values)
        if arr.ndim == 0:
            if self.n is None:
                raise ValueError("scalar column in an unsized iterator")
            arr = np.full(self.n, arr)
        if arr.ndim != 1:
            raise ValueError(f"column {name!r} must be 1-D, got {arr.shape}")
        if self.n is None:
            self.n = len(arr)
        elif len(arr) != self.n:
            raise ValueError(
                f"column {name!r} has length {len(arr)}, expected {self.n}")
        self.columns[name] = arr

    def __getitem__(self, name):
        return self.columns[name]

    def __contains__(self, name):
        return name in self.columns

    def __len__(self):
        return self.n

    @property
    def src(self):
        return SRC

    def select(self, mask):
        """Row-filter (used for domain restrictions, reference
        InfiniteExaModels.jl/src/transform.jl:448-451)."""
        mask = np.asarray(mask, dtype=bool)
        return Iterator({k: v[mask] for k, v in self.columns.items()})

    def copy(self):
        return Iterator(dict(self.columns), n=self.n)

    @staticmethod
    def single():
        """The one-row empty iterator ``[(;)]`` used for finite constraints
        (reference InfiniteExaModels.jl/src/transform.jl:440)."""
        return Iterator({}, n=1)

    @staticmethod
    def product(*itrs):
        """Cartesian product of iterators, merging their columns (reference
        ``merge.(Iterators.product(itrs...))`` at transform.jl:445).

        Row ordering is C-order over (itr1, itr2, ...): the LAST iterator's
        index varies fastest.  This matches numpy ``reshape`` semantics used
        when reshaping family outputs to support grids.
        """
        itrs = [i for i in itrs]
        if not itrs:
            return Iterator.single()
        if len(itrs) == 1:
            return itrs[0].copy()
        lens = [len(i) for i in itrs]
        total = int(np.prod(lens))
        out = Iterator({}, n=total)
        for pos, itr in enumerate(itrs):
            reps_outer = int(np.prod(lens[:pos])) if pos else 1
            reps_inner = int(np.prod(lens[pos + 1:])) if pos + 1 < len(itrs) else 1
            for name, col in itr.columns.items():
                if name in out.columns:
                    raise ValueError(f"duplicate column {name!r} in product")
                tiled = np.tile(np.repeat(col, reps_inner), reps_outer)
                out[name] = tiled
        return out

    def evaluate_index(self, idx):
        """Evaluate an int | IdxAff index against integer columns -> array."""
        if isinstance(idx, int):
            return np.full(self.n, idx, dtype=np.int64)
        if isinstance(idx, IdxAff):
            out = idx.evaluate(self.columns)
            return np.broadcast_to(np.asarray(out, dtype=np.int64), (self.n,)).copy()
        raise TypeError(f"bad index {idx!r}")
