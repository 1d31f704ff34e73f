"""Carry solver state and KKT blocks across as numpy arrays.

A test can take another implementation's IPM state at iteration k (as a
dict of numpy arrays keyed by :class:`~.solvers.ipm.IpmState` field names),
run one step of this package from it, and compare.  This module imports no
other framework; the caller does that side of the conversion.
"""
from __future__ import annotations

import numpy as np
import torch

from .solvers.ipm import IpmState


def state_from_numpy(d, device):
    """``IpmState`` of tensors on ``device`` from a dict of numpy arrays
    (dtypes kept: float64 stays float64, int32 stays int32)."""
    missing = set(IpmState._fields) - set(d)
    if missing:
        raise KeyError(f"state is missing fields {sorted(missing)}")
    return IpmState(**{k: torch.as_tensor(np.array(d[k]), device=device)
                       for k in IpmState._fields})


def state_to_numpy(st):
    """Dict of numpy arrays keyed by ``IpmState`` field names."""
    return {k: v.detach().cpu().numpy() for k, v in st._asdict().items()}


def kkt_blocks_from_numpy(blocks, device):
    """The band backend's ``(D, L, B, C)`` blocks as tensors on ``device``."""
    return tuple(torch.as_tensor(np.array(b), device=device)
                 for b in blocks)
