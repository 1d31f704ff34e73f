"""Sharding of SIMD model evaluation over the ranks of a :class:`Mesh`.

The row axis of every family's static gather tables is split into one
contiguous slice per rank, while the decision vector, bounds and theta stay
replicated: each rank evaluates only its own rows, and the collectives of
:class:`~.collectives.Mesh` combine the partial results into replicated
outputs (``SimdModel`` says which output takes which collective) -- data
parallelism over supports and scenarios, the axis the SIMD families batch
over.

The linear algebra follows the data: the structured KKT backends built over
a sharded model (``solvers/scenario_shard.py``, ``solvers/band_shard.py``)
assemble and factor each rank's own scenario or time blocks, and their only
communication is the border's Schur corner, the halos and the BCR tail.
"""
from __future__ import annotations

import os

import torch

from ..utils.device import resolve_device
from .collectives import Mesh


def make_mesh(device=None, group=None):
    """A :class:`Mesh` over an initialized process group (the default group
    when ``group`` is None): one rank per device.  ``device`` defaults to
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK`` as ``torchrun``
    sets it, else the rank); pass ``device="cpu"`` for a CPU mesh."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.initialize)")
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank(group)))
        count = torch.cuda.device_count()
        device = f"cuda:{local % count}" if count else "cuda"
    return Mesh(resolve_device(device), group)


def shard_model(model, mesh):
    """Keep this rank's contiguous slice of each family's (padded) rows.

    With the model built with ``row_pad = mesh.size`` every family's padded
    row count divides the mesh; a family whose count does not is evaluated
    whole by rank 0 alone (the only case left that is not shared out).
    Returns the model (modified in place)."""
    model.shard(mesh)
    return model


def sharded_fraction(model, mesh):
    """Fraction of the (logical) family rows that were shared out."""
    total = sharded = 0
    for fam in model.con_fams + model.obj_fams:
        n_pad = model.padded_rows(fam)
        total += fam.n
        if n_pad > 0 and n_pad % mesh.size == 0:
            sharded += fam.n
    return sharded / max(total, 1)
