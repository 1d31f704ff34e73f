"""Collectives between the ranks of a process group: the port's counterpart
of the ``psum`` / ``all_gather`` / ``ppermute`` that the reference package
runs inside ``shard_map`` over a device mesh.

One process drives one device.  A :class:`Mesh` is the process group plus
this rank's device; every rank runs the same program on its own share of
the data, and the values a collective returns are the same bytes on every
rank (an all-reduce combines each element once and hands the result to
every rank), so host decisions taken on them never branch apart.

The transport is fixed by the group's backend, never found by catching an
error:

- ``nccl``: every op runs on the card's tensors.
- ``gloo`` with CUDA tensors (several ranks sharing one card, which NCCL
  refuses): the ops named in :data:`GLOO_CUDA_STAGED` are staged through
  host memory (copied to the CPU, run there, copied back); gloo runs the
  others on the CUDA tensors itself.
- ``gloo`` with CPU tensors: every op runs as is.

Every op can be recorded: inside ``with mesh.recording() as log`` each
collective appends ``(kind, elements)`` to ``log``, which the tests and the
smoke script read to hold the communication of each phase to its size.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist

# ops that gloo cannot run on CUDA tensors: point-to-point sends and
# receives (gloo's pairs address host buffers only)
GLOO_CUDA_STAGED = frozenset({"ppermute"})


class Mesh:
    """A process group and the device this rank computes on.

    ``group=None`` is the default (world) group, which must be initialized
    before a mesh is made over it.  ``rank``/``size`` are this process's
    rank and the group's size; ``backend`` the group's backend (``"nccl"``
    or ``"gloo"``); ``staged`` the ops routed through host memory."""

    def __init__(self, device, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        self.staged = (GLOO_CUDA_STAGED if self.backend == "gloo"
                       and self.device.type == "cuda" else frozenset())
        self._log = None

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"backend={self.backend!r}, device={self.device})")

    # -- recording --------------------------------------------------------
    @contextmanager
    def recording(self):
        """Log ``(kind, elements)`` of every collective run inside."""
        saved, self._log = self._log, []
        try:
            yield self._log
        finally:
            self._log = saved

    def _record(self, kind, t):
        if self._log is not None:
            self._log.append((kind, int(t.numel())))

    def _host(self, kind, t):
        """``t`` or its host copy when ``kind`` is staged."""
        return t.cpu() if kind in self.staged else t

    # -- collectives ------------------------------------------------------
    def psum(self, t):
        """Elementwise sum over the ranks (all-reduce); a new tensor."""
        self._record("psum", t)
        out = self._host("psum", t).clone()
        if self.size > 1:
            dist.all_reduce(out, group=self.group)
        return out.to(t.device)

    def psum_scalar(self, t):
        """The sum over the ranks of a 0-d partial (a norm's, a flag's)."""
        self._record("psum_scalar", t)
        out = self._host("psum_scalar", t).reshape(1).clone()
        if self.size > 1:
            dist.all_reduce(out, group=self.group)
        return out.reshape(()).to(t.device)

    def all_gather(self, t):
        """Every rank's ``t`` stacked in rank order: ``(size, *t.shape)``."""
        self._record("all_gather", t)
        src = self._host("all_gather", t).reshape(-1).contiguous()
        if self.size > 1:
            out = src.new_empty(self.size * src.numel())
            dist.all_gather_into_tensor(out, src, group=self.group)
        else:
            out = src.clone()
        return out.reshape((self.size,) + tuple(t.shape)).to(t.device)

    def _peer(self, shift):
        """The global rank ``shift`` places along the ring."""
        r = (self.rank + shift) % self.size
        return r if self.group is None else dist.get_global_rank(
            self.group, r)

    def _ppermute(self, t, shift):
        self._record("ppermute", t)
        src = self._host("ppermute", t).contiguous()
        if self.size == 1:
            return src.clone().to(t.device)
        out = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, self._peer(shift), self.group),
               dist.P2POp(dist.irecv, out, self._peer(-shift), self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out.to(t.device)

    def ppermute_right(self, t):
        """Ring shift to the right: rank i receives rank i-1's ``t`` (rank
        0 receives the last rank's)."""
        return self._ppermute(t, 1)

    def ppermute_left(self, t):
        """Ring shift to the left: rank i receives rank i+1's ``t`` (the
        last rank receives rank 0's)."""
        return self._ppermute(t, -1)

    def barrier(self):
        if self.size > 1:
            dist.barrier(group=self.group)
