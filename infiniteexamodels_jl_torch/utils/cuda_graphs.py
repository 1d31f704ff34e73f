"""The port's CUDA graphs: which calls are captured, where the graphs are
kept and how often each is replayed.

A call of some tens to thousands of small kernels (an AD sweep,
``ops/model.py``; the band or scenario KKT's solve,
``solvers/block_tridiag.py``; a stretch of the IPM step's own vector
algebra, ``solvers/ipm.py``) replays from one graph launch, the same
kernels in the same order, so its result is the eager call's bit for bit.
Its owner keeps a :class:`GraphCache`, which decides (:func:`graphable`),
keeps the graphs by key and counts under the owner's counter names.

A call's arguments and results are tensors, ``None`` or tuples of them
(``NamedTuple`` s too, nested).  They travel into and out of the graph
packed, one flat tensor a dtype (:class:`_Packing`), so a call costs two
copies in (the dtype's vectors, its 0-d tensors) and one clone out per
dtype, however many tensors it takes and gives.
"""
from __future__ import annotations

import gc

import torch

from .timers import count

# each packed tensor with elements starts a multiple of ALIGN elements into
# its flat tensor, which the allocator aligns to 512 bytes: a view of it is
# aligned as a fresh tensor is, so a kernel over it vectorizes, and a
# reduction over it adds in the same order, as over a fresh one
ALIGN = 64


def graphable(device, mesh):
    """Whether calls on ``device`` with ``mesh`` run as CUDA graphs: on a
    CUDA device without a mesh.  A mesh's collectives (gloo's) cannot be
    captured, and the CPU has no graphs."""
    return mesh is None and torch.device(device).type == "cuda"


def _flatten(tree, leaves):
    """The structure of ``tree`` (tuples, their types kept, over leaves);
    its leaves are appended to ``leaves``."""
    if isinstance(tree, tuple):
        return type(tree), tuple(_flatten(t, leaves) for t in tree)
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    """The tree of structure ``spec`` over the iterator ``leaves``."""
    if spec is None:
        return next(leaves)
    typ, kids = spec
    items = [_unflatten(k, leaves) for k in kids]
    return typ._make(items) if hasattr(typ, "_make") else typ(items)


class _Packing:
    """Where each tensor of a list lies in one flat tensor of its dtype:
    those with elements first, each from a multiple of :data:`ALIGN`
    elements, then the 0-d ones, an element each.  ``None`` stays
    ``None``."""

    def __init__(self, tensors):
        self.count = len(tensors)
        groups = {}
        for i, t in enumerate(tensors):
            if t is not None:
                groups.setdefault(t.dtype, []).append(i)
        # per dtype: the positions of the tensors with elements, their
        # shapes where not 1-D, the zero pad after each (or None), the
        # positions of the 0-d ones, the sizes of the flat tensor's parts
        # and the index of each tensor's part
        self.groups = []
        for idx in groups.values():
            vecs = [i for i in idx if tensors[i].dim()]
            scalars = [i for i in idx if not tensors[i].dim()]
            shapes, pads, sizes, parts = [], [], [], []
            for k, i in enumerate(vecs):
                t = tensors[i]
                shapes.append(None if t.dim() == 1 else t.shape)
                parts.append(len(sizes))
                sizes.append(t.numel())
                pad = -sizes[-1] % ALIGN
                last = k + 1 == len(vecs) and not scalars
                pads.append(None if last or not pad else t.new_zeros(pad))
                if pads[-1] is not None:
                    sizes.append(pad)
            self.groups.append((vecs, shapes, pads, scalars, sizes, parts,
                                sum(sizes)))

    def pack(self, tensors):
        """The flat tensors of ``tensors``, new ones."""
        out = []
        for vecs, _, pads, scalars, _, _, _ in self.groups:
            pieces = []
            for i, pad in zip(vecs, pads):
                pieces.append(tensors[i].reshape(-1))
                if pad is not None:
                    pieces.append(pad)
            if len(scalars) == 1:
                pieces.append(tensors[scalars[0]].reshape(1))
            elif scalars:
                pieces.append(torch.stack([tensors[i] for i in scalars]))
            out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces))
        return out

    def fill(self, flats, tensors):
        """Copies ``tensors`` into ``flats``: a launch for a dtype's
        tensors with elements and one for its 0-d ones."""
        for flat, (vecs, shapes, pads, scalars, _, _, end) in zip(
                flats, self.groups):
            if vecs:
                pieces = []
                for i, shape, pad in zip(vecs, shapes, pads):
                    t = tensors[i]
                    pieces.append(t if shape is None else t.reshape(-1))
                    if pad is not None:
                        pieces.append(pad)
                head = flat[:end] if scalars else flat
                if len(pieces) == 1:
                    head.copy_(pieces[0])
                else:
                    torch.cat(pieces, out=head)
            tail = flat[end:] if vecs else flat
            if len(scalars) == 1:
                tail.copy_(tensors[scalars[0]])
            elif scalars:
                torch.stack([tensors[i] for i in scalars], out=tail)

    def unpack(self, flats):
        """The tensors, as views of ``flats``, in their places."""
        out = [None] * self.count
        for flat, (vecs, shapes, _, scalars, sizes, parts, end) in zip(
                flats, self.groups):
            if vecs:
                split = flat[:end].split(sizes) if scalars else \
                    flat.split(sizes)
                for i, shape, k in zip(vecs, shapes, parts):
                    out[i] = split[k] if shape is None else \
                        split[k].view(shape)
            if scalars:
                for i, v in zip(scalars, (flat[end:] if vecs
                                          else flat).unbind()):
                    out[i] = v
        return out


class CapturedCall:
    """``body(*args, **kwargs)`` captured as a CUDA graph over static
    inputs.  A call packs its arguments into them (:class:`_Packing`),
    replays, and returns views of clones of the graph's packed outputs,
    which the next replay overwrites (the solver holds a step's Jacobian
    values while the SOC sweeps again)."""

    def __init__(self, body, args, kwargs):
        leaves = []
        self.spec = _flatten(tuple(args), leaves)
        self.into = _Packing(leaves)
        self.static = [f.detach().clone() for f in self.into.pack(leaves)]
        self.inputs = _unflatten(self.spec,
                                 iter(self.into.unpack(self.static)))
        self.out_spec = self.out = self.outputs = None

        def run():
            # the body's own outputs, packed inside the graph
            self.outputs = body(*self.inputs, **kwargs)
            out = []
            self.out_spec = _flatten(self.outputs, out)
            if self.out is None:
                self.out = _Packing(out)
            return self.out.pack(out)

        self.packed = self._record(run)

    def _record(self, run):
        """Runs ``run`` once on a side stream, then captures it into
        :attr:`graph`; returns what the capture returned."""
        with torch.cuda.device(self.static[0].device):
            # one eager run on a side stream first, as ``torch.cuda.graph``
            # asks: lazy initialization stays out of the capture
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            # no garbage collection inside the capture: a dead cycle that
            # holds another graph (an earlier model's) would destroy that
            # graph there, a call the capture forbids, which invalidates it
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph):
                    packed = run()
            finally:
                if collecting:
                    gc.enable()
        return packed

    def __call__(self, args):
        leaves = []
        _flatten(tuple(args), leaves)
        return self.replay(leaves)

    def replay(self, leaves):
        """The call on the flattened arguments ``leaves``."""
        self.into.fill(self.static, leaves)
        self.graph.replay()
        out = self.out.unpack([p.clone() for p in self.packed])
        return _unflatten(self.out_spec, iter(out))


class GraphCache:
    """The graphs of one owner's calls on ``device`` with ``mesh``.

    ``cache(tag, body, *args, **kwargs)`` is ``body(*args, **kwargs)``:
    replayed from the graph of ``tag``, the keywords and the arguments'
    structure, shapes and dtypes, captured at the first such call, where
    :attr:`on` (:func:`graphable`) and every argument's leaf is a tensor
    on the owner's kind of device or ``None``; else run eagerly.  Each call
    adds one to the counter named ``captures``, ``replays`` or ``eager``.
    The graphs read what ``body`` reads besides its arguments where it was
    captured, so the owner makes a new cache when that moves."""

    def __init__(self, device, mesh, captures, replays, eager):
        self.on = graphable(device, mesh)
        self.cuda = torch.device(device).type == "cuda"
        self.counters = captures, replays, eager
        self.graphs = {}

    def __call__(self, tag, body, *args, **kwargs):
        captures, replays, eager = self.counters
        if self.on:
            leaves = []
            spec = _flatten(args, leaves)
            sig = _signature(leaves, self.cuda)
            if sig is not None:
                key = (tag, tuple(kwargs.items()), spec, sig)
                g = self.graphs.get(key)
                if g is None:
                    g = self.graphs[key] = CapturedCall(body, args, kwargs)
                    count(captures)
                else:
                    count(replays)
                return g.replay(leaves)
        count(eager)
        return body(*args, **kwargs)


def _signature(leaves, cuda):
    """The shapes and dtypes of ``leaves``, or None unless each is a tensor
    on the owner's kind of device (``cuda``) or None, and one a tensor."""
    sig = []
    for t in leaves:
        if t is None:
            sig.append(None)
        elif isinstance(t, torch.Tensor) and t.is_cuda == cuda:
            sig.append((t.shape, t.dtype))
        else:
            return None
    return tuple(sig) if sig.count(None) < len(sig) else None
