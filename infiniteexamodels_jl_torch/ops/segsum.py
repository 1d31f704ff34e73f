"""Deterministic scatter-add as a build-time gather + segment-sum plan.

``out[dest[i]] += vals[i]`` through ``index_add_`` sums float64 with atomics
on CUDA, so two runs of the same solve can round differently.  Every
destination pattern in this package is static (fixed by the transcription),
so the scatter is precomputed once: the value positions are sorted by
destination (stably, keeping the original order inside each destination)
and the destinations are bucketed by multiplicity into power-of-two widths.
Each bucket is a ``(rows, width)`` take-table padded with a sentinel that
points at an appended zero, applied as one gather and one fixed-order row
reduction; one store to unique indices writes every bucket's sums.

A destination of multiplicity ``c`` takes a row of width ``< 2c``, so the
tables hold fewer than twice the stream's length whatever the largest
multiplicity is (a first-stage variable touched by every scenario row does
not pad every other destination to its width).  The same plan serves a
scatter-max (used for the per-row Jacobian scaling).
"""
from __future__ import annotations

import numpy as np
import torch


def gather_plan(dest, sel=None, nnz_total=None):
    """Buckets ``[(tab, u), ...]`` (numpy) for ``out[dest[k]] +=
    vals[sel[k]]``.

    ``sel`` defaults to ``arange(len(dest))`` and ``nnz_total`` (the
    sentinel, i.e. the length of the value stream) to ``len(dest)``.
    ``tab[r, :]`` lists, in original order, the value positions summed into
    ``out[u[r]]``; padding entries hold the sentinel.  Buckets come in
    increasing width and each ``u`` is sorted."""
    dest = np.asarray(dest, dtype=np.int64).reshape(-1)
    sel = (np.arange(len(dest), dtype=np.int64) if sel is None
           else np.asarray(sel, dtype=np.int64).reshape(-1))
    nnz_total = len(dest) if nnz_total is None else int(nnz_total)
    if len(dest) == 0:
        return []
    order = np.argsort(dest, kind="stable")
    sel_s, dest_s = sel[order], dest[order]
    u, start, counts = np.unique(dest_s, return_index=True,
                                 return_counts=True)
    width = 1 << np.ceil(np.log2(counts)).astype(np.int64)
    buckets = []
    for w in np.unique(width):
        rows = np.nonzero(width == w)[0]
        idx = start[rows, None] + np.arange(w)[None, :]
        valid = np.arange(w)[None, :] < counts[rows, None]
        tab = np.where(valid, sel_s[np.minimum(idx, len(sel_s) - 1)],
                       nnz_total)
        buckets.append((tab.astype(np.int64), u[rows].astype(np.int64)))
    return buckets


class SegmentSum:
    """A :func:`gather_plan` whose tables live on ``device``: calling it on
    a value stream of length ``nnz_total`` returns the ``size`` sums."""

    def __init__(self, dest, size, device, sel=None, nnz_total=None):
        buckets = gather_plan(dest, sel, nnz_total)
        self.size = int(size)
        self.tabs = [torch.as_tensor(t, device=device) for t, _ in buckets]
        self.u = torch.as_tensor(
            np.concatenate([u for _, u in buckets]) if buckets
            else np.zeros(0, np.int64), device=device)

    @property
    def entries(self):
        """Entries held by the take-tables and the destination index."""
        return sum(t.numel() for t in self.tabs) + self.u.numel()

    def __call__(self, vals, reduce="sum"):
        """``reduce="amax"`` takes the maximum with 0 (the scatter-max of
        nonnegative values into zeros)."""
        out = vals.new_zeros(self.size)
        if not self.tabs:
            return out
        vals_p = torch.cat([vals, vals.new_zeros(1)])
        segs = [vals_p[t].sum(dim=1) if reduce == "sum"
                else vals_p[t].amax(dim=1) for t in self.tabs]
        out[self.u] = segs[0] if len(segs) == 1 else torch.cat(segs)
        return out
