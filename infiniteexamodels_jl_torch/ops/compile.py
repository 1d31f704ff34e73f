"""Family compilation: (template, iterator) -> static index arrays + one
``torch.func``-traceable row function.

The compile step realizes the SIMD invariant engineered by the reference
(InfiniteExaModels.jl/src/transform.jl:458,559,597,700): the number of distinct
templates is O(#families), never O(#supports), so AD traces once per family
and evaluates as a vmapped batch with an identical per-row sparsity pattern.
Because iterator columns are concrete at build time, every variable/parameter
flat index below is a *static* numpy array -- the device sees pure gathers with
static shapes.
"""
from __future__ import annotations

import numpy as np

from .expr import collect_entries, emit


class CompiledFamily:
    """Static data + row function for one constraint/objective family.

    Attributes
    ----------
    n        : number of rows
    kx,kp,kf : number of gathered variable / parameter / float-data slots
    vidx     : (n, kx) int array of flat x indices
    pidx     : (n, kp) int array of flat theta indices
    fdata    : (n, kf) float array of per-row data
    fn       : callable (xv, pv, fv) -> scalar, ``torch.func`` traceable
    offset   : row offset in the flat constraint vector (None for objectives)
    """

    __slots__ = ("name", "n", "kx", "kp", "kf", "vidx", "pidx", "fdata",
                 "fn", "offset", "pairs_a", "pairs_b")

    def __init__(self, expr, itr, offset=None, name=""):
        self.name = name
        self.n = len(itr)
        self.offset = offset

        var_entries, par_entries, field_names = collect_entries(expr)
        self.kx = len(var_entries)
        self.kp = len(par_entries)
        self.kf = len(field_names)

        var_slots = {e.key(): j for j, e in enumerate(var_entries)}
        par_slots = {e.key(): j for j, e in enumerate(par_entries)}
        field_slots = {f: j for j, f in enumerate(field_names)}
        self.fn = emit(expr, var_slots, par_slots, field_slots)

        n = self.n
        self.vidx = _entry_indices(var_entries, itr, n)
        self.pidx = _entry_indices(par_entries, itr, n)
        if self.kf:
            self.fdata = np.stack(
                [np.asarray(itr[f], dtype=np.float64) for f in field_names],
                axis=1)
        else:
            self.fdata = np.zeros((n, 0), dtype=np.float64)

        # Hessian slot pairs: the FULL kx*kx square.  Using the full square
        # (not a triangle) makes plain scatter-add assembly correct even when
        # two slots alias the same flat variable index at some rows (e.g.
        # ``x[i]`` and ``x[0]`` colliding at row i=0): the cross terms then
        # land on the diagonal with the right multiplicity.
        a, b = np.meshgrid(np.arange(self.kx), np.arange(self.kx),
                           indexing="ij")
        self.pairs_a = a.reshape(-1).astype(np.int32)
        self.pairs_b = b.reshape(-1).astype(np.int32)

    # -- static sparsity patterns ---------------------------------------
    def jac_rows(self):
        return np.repeat(self.offset + np.arange(self.n, dtype=np.int64),
                         self.kx)

    def jac_cols(self):
        return self.vidx.reshape(-1).astype(np.int64)

    def hess_rows_cols(self):
        """COO (row, col) pairs of the full symmetric Hessian contribution,
        flattened over (n, kx*kx)."""
        r = self.vidx[:, self.pairs_a].reshape(-1).astype(np.int64)
        c = self.vidx[:, self.pairs_b].reshape(-1).astype(np.int64)
        return r, c


def _entry_indices(entries, itr, n):
    if not entries:
        return np.zeros((n, 0), dtype=np.int32)
    cols = []
    for e in entries:
        holder = e.var if hasattr(e, "var") else e.param
        strides = _strides(holder.shape)
        flat = np.full(n, holder.offset, dtype=np.int64)
        for ax, idx in enumerate(e.idx):
            flat = flat + strides[ax] * itr.evaluate_index(idx)
        lo, hi = holder.offset, holder.offset + holder.length
        if flat.size and (flat.min() < lo or flat.max() >= hi):
            bad = int(flat.min()) if flat.min() < lo else int(flat.max())
            raise IndexError(
                f"index out of range for {holder.name!r}: flat {bad} outside "
                f"[{lo},{hi}) -- check iterator index columns for entry {e!r}")
        cols.append(flat)
    return np.stack(cols, axis=1).astype(np.int32)


def _strides(shape):
    st, acc = [], 1
    for d in reversed(shape):
        st.append(acc)
        acc *= d
    return tuple(reversed(st))
