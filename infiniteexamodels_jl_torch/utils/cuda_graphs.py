"""The port's CUDA graphs: which calls are captured, where the graphs are
kept and how often each is replayed.

A call of some hundreds or thousands of small kernels (an AD sweep,
``ops/model.py``; the band or scenario KKT's solve,
``solvers/block_tridiag.py``) replays from one graph launch, the same
kernels in the same order, so its result is the eager call's bit for bit.
Its owner keeps a :class:`GraphCache`, which decides (:func:`graphable`),
keeps the graphs by key and counts under the owner's counter names.
"""
from __future__ import annotations

import gc

import torch

from .timers import count


def graphable(device, mesh):
    """Whether calls on ``device`` with ``mesh`` run as CUDA graphs: on a
    CUDA device without a mesh.  A mesh's collectives (gloo's) cannot be
    captured, and the CPU has no graphs."""
    return mesh is None and torch.device(device).type == "cuda"


class CapturedCall:
    """``body(*args, **kwargs)`` captured as a CUDA graph over static copies
    of its tensor arguments.  A call copies its arguments into them,
    replays, and returns clones of the graph's outputs, which the next
    replay overwrites (the solver holds a step's Jacobian values while the
    SOC sweeps again)."""

    def __init__(self, body, args, kwargs):
        self.inputs = [a.detach().clone() for a in args]
        with torch.cuda.device(self.inputs[0].device):
            # one eager run on a side stream first, as ``torch.cuda.graph``
            # asks: lazy initialization stays out of the capture
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                body(*self.inputs, **kwargs)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: a dead cycle that
            # holds another graph (an earlier model's) would destroy that
            # graph there, a call the capture forbids, which invalidates it
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph):
                    self.outputs = body(*self.inputs, **kwargs)
            finally:
                if collecting:
                    gc.enable()

    def __call__(self, args):
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        self.graph.replay()
        out = self.outputs
        return (out.clone() if torch.is_tensor(out)
                else tuple(o.clone() for o in out))


class GraphCache:
    """The graphs of one owner's calls on ``device`` with ``mesh``.

    ``cache(tag, body, *args, **kwargs)`` is ``body(*args, **kwargs)``:
    replayed from the graph of ``tag``, the keywords and the arguments'
    shapes and dtypes, captured at the first such call, where :attr:`on`
    (:func:`graphable`) and every argument is a tensor on the owner's kind
    of device; else run eagerly.  Each call adds one to the counter named
    ``captures``, ``replays`` or ``eager``.  The graphs read what ``body``
    reads besides its arguments where it was captured, so the owner makes
    a new cache when that moves."""

    def __init__(self, device, mesh, captures, replays, eager):
        self.on = graphable(device, mesh)
        self.device_type = torch.device(device).type
        self.counters = captures, replays, eager
        self.graphs = {}

    def __call__(self, tag, body, *args, **kwargs):
        captures, replays, eager = self.counters
        if not (self.on and all(
                torch.is_tensor(a) and a.device.type == self.device_type
                for a in args)):
            count(eager)
            return body(*args, **kwargs)
        key = (tag, tuple(kwargs.items()),
               tuple((a.shape, a.dtype) for a in args))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = CapturedCall(body, args, kwargs)
            count(captures)
        else:
            count(replays)
        return g(args)
