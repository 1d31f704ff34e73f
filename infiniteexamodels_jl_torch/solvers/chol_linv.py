"""K1: batched Cholesky ``D = L L^T`` plus the explicit inverse ``L^{-1}``.

Every band or scenario factorization of the structured KKT backend ends in
this function (``block_tridiag._chol_linv``).  :func:`chol_linv` launches
the hand-written Hopper kernel ``csrc/chol_linv.cu`` for a CUDA tensor and
runs :func:`chol_linv_reference` only for a CPU tensor.  The kernel replaces
the reference package's TPU Pallas kernels ``_chol_inv_kernel``
(solvers/pallas_chol.py:38) and ``_chol_inv_kernel2`` (:90); the note at the
top of the CUDA source says what bounds it on the card and how its design
answers that.  :func:`launch_plan` chooses the kernel's path and launch
configuration from the batch, ``n`` and the dtype; the kernel takes it as
given.

Contract (both versions): ``D`` is ``(nb, n, n)``, float64 or float32,
contiguous, ``n`` a multiple of 8 up to :data:`MAX_N`.  Returns
``(L, Linv, ok)`` with zero strict upper triangles; a block that is not SPD
gets NaN in ``L`` and ``Linv``; ``ok`` is a 0-d bool tensor, true iff every
block factored and every entry of ``Linv`` is finite.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import cuda_build

MAX_N = 512          # the band backend's max_block
_SYMBOLS = {torch.float64: "ixm_chol_linv_f64",
            torch.float32: "ixm_chol_linv_f32"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

SMEM_LIMIT = 232448       # bytes of shared memory one CTA may use on sm_90
SMEM_PER_SM = 233472      # ... and one SM holds (228 KB)
STATIC_SMEM = 1024        # kept back per CTA: static flags, the system's 1 KB
MAX_THREADS = 256         # the kernels' __launch_bounds__(256, 3) ...
RESIDENT_WARPS = 24       # ... caps registers at 3 x 8 warps per SM
H100_SMS = 132
CTA_THREADS = (256, 128, 64, 32)   # path "cta", most warps per block first
CLUSTER_CTAS = 8          # CTAs that share one block on path "cluster"
CLUSTER_CTAS_LARGE = 16   # ... above n = 256 (a non-portable cluster size)
_PATH_IDS = {"cta": 1, "cluster": 2}


class LaunchPlan(NamedTuple):
    """How K1 is launched for one batch of blocks.

    ``path``: ``"cta"`` (one CTA of ``threads`` per block, L and L^{-1} in
    shared memory) or ``"cluster"`` (a cluster of ``ctas`` CTAs per block,
    working in the output buffers).  ``smem_bytes`` is the dynamic shared
    memory of one CTA and ``ld`` the leading dimension of the shared-memory
    copies (rows padded by 4 elements, against bank conflicts, where that
    still fits)."""
    path: str
    ctas: int
    threads: int
    smem_bytes: int
    ld: int


def launch_plan(n, dtype, nb=1, sms=H100_SMS):
    """The kernel's path and launch configuration for ``nb`` blocks of size
    ``n`` on a card of ``sms`` SMs: ``"cta"`` while a block and its inverse
    fit in shared memory (f64 n <= 120, f32 n <= 168), ``"cluster"`` above.

    On path "cta" a block gets the most warps (of 8, 4, 2, 1) with which
    the whole batch is resident in one wave.  Where no count manages that,
    it gets the count that needs the fewest waves, the more warps on a tie,
    and from n = 32 on at least 4 warps: there a block's own chain grows
    enough that more warps shorten it more than the extra waves cost
    (k1_sweep times these choices against the other counts)."""
    esize = torch.finfo(dtype).bits // 8
    fits = [ld for ld in (n + 4, n)
            if 2 * n * ld * esize <= SMEM_LIMIT - STATIC_SMEM]
    if not fits:
        ctas = CLUSTER_CTAS if n <= 256 else CLUSTER_CTAS_LARGE
        return LaunchPlan("cluster", ctas, MAX_THREADS, 0, n)
    ld = fits[0]
    smem = 2 * n * ld * esize

    def waves(threads):
        per_sm = min(32, RESIDENT_WARPS // (threads // 32),
                     SMEM_PER_SM // (smem + STATIC_SMEM))
        return -(-nb // (sms * per_sm))

    threads = next((t for t in CTA_THREADS if waves(t) == 1), None)
    if threads is None:
        threads = min(CTA_THREADS[:2] if n >= 32 else CTA_THREADS, key=waves)
    return LaunchPlan("cta", 1, threads, smem, ld)


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
    sms = torch.cuda.get_device_properties(D.device).multi_processor_count
    plan = launch_plan(n, D.dtype, nb, sms)
    stream = torch.cuda.current_stream(D.device).cuda_stream
    with torch.cuda.device(D.device):
        err = fn(D.data_ptr(), L.data_ptr(), Linv.data_ptr(),
                 okb.data_ptr(), nb, n, _PATH_IDS[plan.path], plan.ctas,
                 plan.threads, plan.smem_bytes, plan.ld, stream)
    if err != 0:
        raise RuntimeError(f"chol_linv kernel launch failed: CUDA error "
                           f"{err}")
    chol_linv.launches += 1
    return L, Linv, torch.all(okb)


chol_linv.launches = 0
