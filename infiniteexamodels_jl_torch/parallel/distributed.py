"""Process bootstrap for a multi-device (and multi-host) run.

One process drives one device.  Every rank runs the same script:

    torchrun --nproc-per-node=N script.py

and the script calls :func:`initialize`, then builds its model with
``ExaTranscriptionBackend(IpmSolver, mesh=global_mesh())``.  Every rank
transcribes the whole model on the host, keeps on its device only its own
family rows and KKT blocks, and holds the IPM iterate replicated.

``initialize`` reads the environment ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) unless it is given an
``init_method`` with ``rank`` and ``world_size``.  NCCL needs one card per
rank; several ranks on one card, or on the CPU, use gloo.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .sharding import make_mesh

DEFAULT_TIMEOUT_S = 300.0


def initialize(backend=None, init_method=None, world_size=None, rank=None,
               timeout=DEFAULT_TIMEOUT_S):
    """``init_process_group`` with an explicit backend and timeout
    (seconds): a rank that fails leaves the others blocked in a collective
    for at most ``timeout`` instead of the library's default 30 minutes.

    ``backend`` defaults to NCCL when every rank has a card of its own
    (``LOCAL_WORLD_SIZE`` <= the cards visible) and gloo otherwise.
    ``init_method`` defaults to ``env://`` (the ``torchrun`` environment);
    ``world_size``/``rank`` default to ``WORLD_SIZE``/``RANK``."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        backend = ("nccl" if torch.cuda.is_available()
                   and local <= torch.cuda.device_count() else "gloo")
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=int(world_size), rank=int(rank),
        timeout=datetime.timedelta(seconds=float(timeout)))


def global_mesh(device=None):
    """A mesh over every rank of every process (the default group), ranks
    in order: with ``torchrun`` the ranks of one host are consecutive, so
    a scenario- or time-sharded axis keeps cross-host traffic to the
    border's reductions and the segment halos."""
    return make_mesh(device=device)


def process_info():
    """(rank, world size, devices this process drives, devices in all):
    one process drives one device."""
    return (dist.get_rank(), dist.get_world_size(), 1,
            dist.get_world_size())
