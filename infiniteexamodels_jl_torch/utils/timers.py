"""Spans and counters of the port's solves.

``span(name)`` times one piece of work where it runs.  Inside a solve
(``IpmSolver._solve_impl`` opens a :class:`Recorder`) each span adds its
host duration and its self time (the duration less the part that child
spans cover) to totals keyed by its path, the names of the spans open
around it joined with ``/`` (``ipm.solve/ipm.step/ipm.direction/
kkt.assemble/ad.kkt_vals``), and counts its calls; so every nanosecond of
a span is the self time of exactly one span in its subtree.  Both times
come from ``time.perf_counter_ns``.  ``count(name, k)`` adds to a counter
that no span's calls already give.  Outside a solve a span keeps nothing.

When a ``torch.profiler`` records, a span also opens a record function
of its name, so it lands in the trace beside the kernels it launches, on
the profiler's clock; when none records, none is entered.  The record is
of an operator's scope, as an aten op's is: a user annotation
(``torch.profiler.record_function``) also leaves a copy of itself on the
card's timeline, which a trace reader that sorts events by their device
takes for the card's work.
"""
from __future__ import annotations

import contextvars
import functools
import time

import torch
from torch._C._profiler import _RecordFunctionFast as record_function

_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns
_current = contextvars.ContextVar("ixm_span_recorder", default=None)


class Recorder:
    """The span totals and counters of one solve: ``with Recorder() as
    rec:``, and the spans and counts of the block land in ``rec``."""

    def __init__(self):
        self.totals = {}      # path -> [calls, ns, self ns]
        self.counts = {}
        self.stack = []       # the open spans: [path, ns of their children]
        self._token = None

    def __enter__(self):
        self._token = _current.set(self)
        return self

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False

    def spans(self):
        """``{path: {"calls", "s", "self_s"}}``, in seconds."""
        return {path: {"calls": c, "s": ns / 1e9, "self_s": own / 1e9}
                for path, (c, ns, own) in self.totals.items()}


class span:
    """``with span(name):`` times the block (see the module's note)."""

    __slots__ = ("name", "rec", "frame", "t0", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        rec = self.rec = _current.get()
        if rec is not None:
            stack = rec.stack
            path = (stack[-1][0] + "/" + self.name) if stack else self.name
            self.frame = [path, 0]
            stack.append(self.frame)
            self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            dt = _clock() - self.t0
            stack = rec.stack
            stack.pop()
            if stack:
                stack[-1][1] += dt
            path, children = self.frame
            tot = rec.totals.get(path)
            if tot is None:
                rec.totals[path] = [1, dt, dt - children]
            else:
                tot[0] += 1
                tot[1] += dt
                tot[2] += dt - children
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def spanned(name):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class phases:
    """Consecutive spans of one block: ``with phases() as phase:``, then
    each ``phase(name)`` closes the span the last one opened and opens
    ``name``; the block's end closes the last."""

    def __init__(self):
        self._open = None

    def __call__(self, name):
        self.close()
        self._open = span(name)
        self._open.__enter__()

    def close(self):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def count(name, k=1):
    """Adds ``k`` to the counter ``name`` of the solve in progress."""
    rec = _current.get()
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + k
