"""Deterministic scatter-add as a build-time gather + segment-sum plan.

``out[dest[i]] += vals[i]`` through ``index_add_`` sums float64 with atomics
on CUDA, so two runs of the same solve can round differently.  Every
destination pattern in this package is static (fixed by the transcription),
so the scatter is precomputed once: the value positions are sorted by
destination (stably, keeping the original order inside each destination),
packed into a ``(n_unique, max_multiplicity)`` take-table padded with a
sentinel that points at an appended zero, and applied as one gather, one
fixed-order row reduction and one store to unique indices.  The same plan
serves a scatter-max (used for the per-row Jacobian scaling).
"""
from __future__ import annotations

import numpy as np
import torch


def gather_plan(dest, sel=None, nnz_total=None):
    """(tab, u) numpy tables for ``out[dest[k]] += vals[sel[k]]``.

    ``sel`` defaults to ``arange(len(dest))`` and ``nnz_total`` (the
    sentinel, i.e. the length of the value stream) to ``len(dest)``.
    ``tab[r, :]`` lists, in original order, the value positions summed into
    ``out[u[r]]``; padding entries hold the sentinel."""
    dest = np.asarray(dest, dtype=np.int64).reshape(-1)
    sel = (np.arange(len(dest), dtype=np.int64) if sel is None
           else np.asarray(sel, dtype=np.int64).reshape(-1))
    nnz_total = len(dest) if nnz_total is None else int(nnz_total)
    if len(dest) == 0:
        return np.zeros((0, 1), np.int64), np.zeros(0, np.int64)
    order = np.argsort(dest, kind="stable")
    sel_s, dest_s = sel[order], dest[order]
    u, start, counts = np.unique(dest_s, return_index=True,
                                 return_counts=True)
    mult = int(counts.max())
    idx = start[:, None] + np.arange(mult)[None, :]
    valid = np.arange(mult)[None, :] < counts[:, None]
    tab = np.where(valid, sel_s[np.minimum(idx, len(sel_s) - 1)], nnz_total)
    return tab.astype(np.int64), u.astype(np.int64)


def apply_plan(vals, tab, u, size, reduce="sum"):
    """Run a plan from :func:`gather_plan` on a value stream ``vals``
    (whose length is the plan's sentinel).  ``reduce="amax"`` takes the
    maximum with 0 (the scatter-max of nonnegative values into zeros)."""
    vals_p = torch.cat([vals, vals.new_zeros(1)])
    g = vals_p[tab]
    seg = g.sum(dim=1) if reduce == "sum" else g.amax(dim=1)
    out = vals.new_zeros(size)
    out[u] = seg
    return out


class SegmentSum:
    """A :func:`gather_plan` whose tables live on ``device``."""

    def __init__(self, dest, size, device):
        tab, u = gather_plan(dest)
        self.size = int(size)
        self.tab = torch.as_tensor(tab, device=device)
        self.u = torch.as_tensor(u, device=device)

    def __call__(self, vals, reduce="sum"):
        return apply_plan(vals, self.tab, self.u, self.size, reduce)
