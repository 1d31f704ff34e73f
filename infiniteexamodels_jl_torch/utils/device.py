"""Device selection for the port's entry points.

Every entry point (``ExaTranscriptionBackend``, ``Core.build``,
``SimdModel``) runs on the CUDA card unless the caller names another
device.  There is no silent CPU fallback: asking for the card on a host
without one raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; raise when CUDA is requested but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev
