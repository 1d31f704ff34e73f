"""The traced requests, summarised in memory from the profiler's raw events
(no Chrome trace is written, and no per-event Python objects beyond one
pass over the raw list).

A traced run profiles two requests of its window.  The first runs with
the card's activity alone (kernels, copies, sets), which costs the host
little: the device's busy time is the union of their intervals, and the
window is that request's wall time.  The second runs with the host's
operations recorded too, which slows the host about twofold, and gives
only the labels of the idle gaps: each hole in the union of device
intervals, labelled by the benchmark span (``portbench.*``) and the
innermost host operation open across its middle.
"""
from __future__ import annotations

import heapq

import numpy as np

TOP = 10
SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "traced"
DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}
SKIPPED = {"gpu_user_annotation"}


def _classifier(events):
    """``e -> True`` (a kernel, copy or set on the card), ``False`` (the
    host) or ``None`` (the card's copy of a host annotation).  Newer
    torch names each event's activity; older torch gives only its device
    type, a slower call."""
    if events and hasattr(events[0], "activity_type"):
        def by_activity(e):
            act = e.activity_type()
            return None if act in SKIPPED else act in DEVICE_ACTIVITIES
        return by_activity
    import torch

    cuda = torch.autograd.DeviceType.CUDA

    def by_device(e):
        if e.device_type() != cuda:
            return False
        return None if e.name().startswith(SPAN_PREFIX) else True
    return by_device


def _split(events, keep_host):
    """(device (start, end, name) arrays, host arrays or None)."""
    on_device = _classifier(events)
    ds, de, dn, hs, he, hn, ht = [], [], [], [], [], [], []
    for e in events:
        where = on_device(e)
        if where is None or not (where or keep_host):
            continue
        start = e.start_ns()
        end = start + e.duration_ns()
        if where:
            ds.append(start)
            de.append(end)
            dn.append(e.name())
        else:
            hs.append(start)
            he.append(end)
            hn.append(e.name())
            ht.append(e.start_thread_id())
    dev = (np.array(ds, np.int64), np.array(de, np.int64),
           np.array(dn, dtype=object))
    host = None
    if keep_host:
        host = (np.array(hs, np.int64), np.array(he, np.int64),
                np.array(hn, dtype=object), np.array(ht))
    return dev, host


def _union(s, t):
    """Merged intervals (starts, ends) of intervals ``[s, t)``."""
    if not len(s):
        return s, t
    order = np.argsort(s, kind="stable")
    s, t = s[order], t[order]
    reach = np.maximum.accumulate(t)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    starts = s[new]
    ends = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    return starts, ends


def device_summary(events):
    """Busy seconds (the union of the card's intervals) and seconds per
    kernel name, from a trace of the card's activity."""
    (s, t, names), _ = _split(events, keep_host=False)
    starts, ends = _union(s, t)
    per_kernel = {}
    for n, d in zip(names, t - s):
        per_kernel[n] = per_kernel.get(n, 0) + int(d)
    return {"busy_s": int((ends - starts).sum()) / 1e9,
            "kernels_s": {k: v / 1e9 for k, v in per_kernel.items()}}


def idle_gaps(events, window_name=WINDOW):
    """The ``TOP`` longest holes in the card's activity inside the span
    ``window_name``, as ``[label, seconds]``."""
    (s, t, _), (hs, he, hn, ht) = _split(events, keep_host=True)
    win = np.flatnonzero(hn == window_name)
    if not len(win):
        raise RuntimeError("the traced request's span is missing")
    w0, w1, thread = hs[win[0]], he[win[0]], ht[win[0]]
    inside = (t > w0) & (s < w1)
    starts, ends = _union(np.clip(s[inside], w0, w1),
                          np.clip(t[inside], w0, w1))
    lo = np.concatenate([[w0], ends])
    hi = np.concatenate([starts, [w1]])
    width = hi - lo
    mine = ht == thread
    hs, he, hn = hs[mine], he[mine], hn[mine]
    is_span = np.array([n.startswith(SPAN_PREFIX) for n in hn], bool)

    def innermost(mask):
        idx = np.flatnonzero(mask)
        return hn[idx[np.argmax(hs[idx])]] if len(idx) else "-"

    out = []
    for i in heapq.nlargest(TOP, range(len(width)), key=lambda k: width[k]):
        if width[i] <= 0:
            continue
        mid = (lo[i] + hi[i]) // 2
        open_ = (hs <= mid) & (he >= mid)
        out.append([f"{innermost(open_ & is_span)} / "
                    f"{innermost(open_ & ~is_span)}", float(width[i]) / 1e9])
    return out


def top_kernels(kernels_s):
    top = heapq.nlargest(TOP, kernels_s.items(), key=lambda kv: kv[1])
    return [[k[:120], v] for k, v in top]
