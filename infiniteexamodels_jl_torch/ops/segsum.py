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

The plan is computed where it is kept: on the card a sort and a run-length
count of tens of millions of destinations take milliseconds, where the
host's take seconds.
"""
from __future__ import annotations

import numpy as np
import torch


def _as_index(a, device):
    """``a`` (an array, a list or a tensor) as a flat int64 tensor on
    ``device``."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
    return a.to(device=device, dtype=torch.int64).reshape(-1)


def gather_plan(dest, sel=None, nnz_total=None, device=None):
    """Buckets ``[(tab, u), ...]`` (int64 tensors on ``device``) for
    ``out[dest[k]] += vals[sel[k]]``.

    ``dest`` and ``sel`` are tensors or arrays; ``device`` defaults to
    ``dest``'s (the CPU for an array), and the plan is computed there: a
    stable sort of the destinations, their run lengths, and one padded
    gather a width.  ``sel`` defaults to ``arange(len(dest))`` and
    ``nnz_total`` (the sentinel, i.e. the length of the value stream) to
    ``len(dest)``.  ``tab[r, :]`` lists, in original order, the value
    positions summed into ``out[u[r]]``; padding entries hold the sentinel.
    Buckets come in increasing width and each ``u`` is sorted."""
    if device is None:
        device = dest.device if torch.is_tensor(dest) else "cpu"
    dest = _as_index(dest, device)
    nnz_total = len(dest) if nnz_total is None else int(nnz_total)
    if len(dest) == 0:
        return []
    dest_s, order = torch.sort(dest, stable=True)
    sel_s = order if sel is None else _as_index(sel, device)[order]
    u, counts = torch.unique_consecutive(dest_s, return_counts=True)
    start = torch.cumsum(counts, 0) - counts
    # the least power of two >= each count, exactly: the float estimate
    # corrected by one step either way
    width = torch.ones_like(counts) << torch.ceil(
        torch.log2(counts.double())).long()
    width = torch.where(width < counts, width << 1, width)
    width = torch.where((width >> 1) >= counts, width >> 1, width)
    # rows grouped by width, increasing, each group in destination order
    width_s, rows_all = torch.sort(width, stable=True)
    widths, sizes = torch.unique_consecutive(width_s, return_counts=True)
    buckets = []
    for w, rows in zip(widths.tolist(),
                       torch.split(rows_all, sizes.tolist())):
        lane = torch.arange(w, device=device)
        idx = start[rows, None] + lane[None, :]
        valid = lane[None, :] < counts[rows, None]
        tab = torch.where(valid, sel_s[idx.clamp_(max=len(sel_s) - 1)],
                          nnz_total)
        buckets.append((tab, u[rows]))
    return buckets


class SegmentSum:
    """A :func:`gather_plan` computed and kept on ``device``: calling it on
    a value stream of length ``nnz_total`` returns the ``size`` sums.
    ``dest`` and ``sel`` may be arrays or tensors on any device."""

    def __init__(self, dest, size, device, sel=None, nnz_total=None):
        buckets = gather_plan(dest, sel, nnz_total, device=device)
        self.size = int(size)
        self.tabs = [t for t, _ in buckets]
        self.u = (torch.cat([u for _, u in buckets]) if buckets
                  else torch.zeros(0, dtype=torch.int64, device=device))

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
