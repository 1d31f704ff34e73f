"""K1: batched Cholesky ``D = L L^T`` plus the explicit inverse ``L^{-1}``.

Every band or scenario factorization of the structured KKT backend ends in
this function (``block_tridiag._chol_linv``).  :func:`chol_linv` launches
the hand-written Hopper kernel ``csrc/chol_linv.cu`` for a CUDA tensor and
runs :func:`chol_linv_reference` only for a CPU tensor.  The kernel replaces
the reference package's TPU Pallas kernels ``_chol_inv_kernel``
(solvers/pallas_chol.py:38) and ``_chol_inv_kernel2`` (:90); the note at the
top of the CUDA source says what bounds it on the card and how its design
answers that.

Contract (both versions): ``D`` is ``(nb, n, n)``, float64 or float32,
contiguous, ``n`` a multiple of 8 up to :data:`MAX_N`.  Returns
``(L, Linv, ok)`` with zero strict upper triangles; a block that is not SPD
gets NaN in ``L`` and ``Linv``; ``ok`` is a 0-d bool tensor, true iff every
block factored and every entry of ``Linv`` is finite.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build

MAX_N = 512          # the band backend's max_block
_SYMBOLS = {torch.float64: "ixm_chol_linv_f64",
            torch.float32: "ixm_chol_linv_f32"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def _check(D):
    if not torch.is_tensor(D) or D.ndim != 3 or D.shape[-1] != D.shape[-2]:
        raise ValueError("chol_linv expects (nb, n, n) blocks, got "
                         f"{tuple(getattr(D, 'shape', ()))}")
    n = D.shape[-1]
    if n % 8 or not 8 <= n <= MAX_N:
        raise ValueError(f"chol_linv: block size {n} is not a multiple of "
                         f"8 in [8, {MAX_N}]")
    if D.dtype not in _SYMBOLS:
        raise TypeError(f"chol_linv: unsupported dtype {D.dtype}")
    if not D.is_contiguous():
        raise ValueError("chol_linv: D must be contiguous")


def chol_linv_reference(D):
    """Plain PyTorch version: ``cholesky_ex`` plus a triangular solve, with
    the kernel's NaN/ok contract.  The CPU path and the test oracle."""
    _check(D)
    L, info = torch.linalg.cholesky_ex(D)
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(D), upper=False)
    bad = (info != 0)[:, None, None]
    L = torch.where(bad, torch.nan, L)
    Linv = torch.where(bad, torch.nan, Linv)
    return L, Linv, torch.isfinite(Linv).all()


def _kernel(dtype):
    fn = getattr(cuda_build.load("chol_linv"), _SYMBOLS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def chol_linv(D):
    """Batched ``(L, L^{-1}, ok)``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor, an error for anything else."""
    _check(D)
    if D.device.type == "cpu":
        return chol_linv_reference(D)
    if D.device.type != "cuda":
        raise ValueError(f"chol_linv: unsupported device {D.device}")
    nb, n = D.shape[0], D.shape[-1]
    L = torch.empty_like(D)
    Linv = torch.empty_like(D)
    okb = torch.empty(nb, dtype=torch.int32, device=D.device)
    if nb == 0:
        return L, Linv, torch.ones((), dtype=torch.bool, device=D.device)
    fn = _kernel(D.dtype)
    stream = torch.cuda.current_stream(D.device).cuda_stream
    with torch.cuda.device(D.device):
        err = fn(D.data_ptr(), L.data_ptr(), Linv.data_ptr(),
                 okb.data_ptr(), nb, n, stream)
    if err != 0:
        raise RuntimeError(f"chol_linv kernel launch failed: CUDA error "
                           f"{err}")
    chol_linv.launches += 1
    return L, Linv, torch.all(okb != 0)


chol_linv.launches = 0
