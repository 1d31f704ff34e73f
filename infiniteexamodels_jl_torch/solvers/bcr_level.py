"""K2: one level of block cyclic reduction's Schur update after K1.

A BCR level (``block_tridiag._bcr_factor``) factors its odd blocks with K1
and then updates the surviving even blocks and their couplings.  In Gram
form, with ``L`` K1's factor of odd block ``k``::

    W1 = L^{-1} E_odd[k]^T,   W2 = L^{-1} E_even[k]
    D_new[k]   -= W2^T W2            D_new starts as the even blocks
    D_new[k+1] -= W1^T W1            (k + 1 < m_even)
    E_new[k]    = -W1^T W2           (k + 1 < m_even)

:func:`bcr_level_reference` is that in plain PyTorch: the test oracle.
:func:`bcr_level` is the factorization's one entry: for CUDA tensors it
launches the hand-written Hopper kernel ``csrc/bcr_level.cu`` (its note
says what bounds it and how its design answers that), for CPU tensors it
runs the plain version, and it counts the level by route
(``kkt.bcr_fused_levels``, ``kkt.bcr_eager_levels``).  :func:`launch_plan`
says how a level is launched: path ``"smem"`` while three blocks fit one
CTA's shared memory, ``"global"`` above, with the working copies in a
device workspace.

The layout (both routes of :func:`bcr_level`): it reads the level's
couplings from ``Epad`` (``m`` blocks, the last zero) as the solve does
(``E_odd = Epad[1::2]``, ``E_even = Epad[0::2][:m_odd]``), and writes the
next level's ``D_new`` odd blocks first (``D_next[:m_even // 2]`` are
``D_new[1::2]``, the rest ``D_new[0::2]``), so the next K1 reads one
contiguous batch, and ``E_new`` with its zero tail into the next level's
``Epad`` buffer.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import cuda_build
from ..utils.timers import count

# the factorization's levels by route: K2, or the plain version (the CPU)
BCR_COUNTERS = ("kkt.bcr_fused_levels", "kkt.bcr_eager_levels")

_SYMBOLS = {torch.float64: "ixm_bcr_level_f64",
            torch.float32: "ixm_bcr_level_f32"}
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)

SMEM_LIMIT = 232448       # bytes of shared memory one CTA may use on sm_90
STATIC_SMEM = 1024        # kept back per CTA: the system's 1 KB
H100_SMS = 132
MAX_WARPS = 8             # the kernel's __launch_bounds__(256, 2)
SCRATCH_BYTES = 256 << 20  # the "global" path's workspace, at most


def _lsolve(L, X):
    """W = L^{-1} X for the Gram-form factor updates: the backward-stable
    batched triangular solve."""
    return torch.linalg.solve_triangular(L, X, upper=False)


def bcr_level_reference(L, E_odd, E_even, D_even):
    """The level's Schur update in Gram form: ``(D_new, E_new)`` from K1's
    factors ``L`` of the ``m_odd`` odd blocks, their couplings ``E_odd``
    (``E[2k+1]``, the last zero when ``m`` is even) and ``E_even``
    (``E[2k]``), and the ``m_even`` even blocks ``D_even``.  ``E_new`` has
    ``m_even - 1`` blocks.  The updates ``-W^T W`` cannot push a block
    spuriously indefinite the way explicit-inverse sandwiches ``E D^{-1}
    E^T`` can."""
    m_odd, m_even = L.shape[0], D_even.shape[0]
    W1 = _lsolve(L, E_odd.transpose(-1, -2))
    W2 = _lsolve(L, E_even)
    D_new = D_even.clone()
    # left term  E[2k-1] D^{-1} E[2k-1]^T = W1^T W1 -> index k (k>=1)
    Lc = torch.matmul(W1.transpose(-1, -2), W1)
    D_new[1:] -= Lc[:m_even - 1]
    # right term E[2k]^T D^{-1} E[2k] = W2^T W2    -> index k (k<m_odd)
    Rc = torch.matmul(W2.transpose(-1, -2), W2)
    D_new[:m_odd] -= Rc
    # new coupling E'_k = -E[2k+1] D^{-1} E[2k] = -W1^T W2
    if m_even > 1:
        E_new = -torch.matmul(W1.transpose(-1, -2), W2)[:m_even - 1]
    else:
        E_new = D_even.new_zeros((0,) + D_even.shape[1:])
    return D_new, E_new


class LaunchPlan(NamedTuple):
    """How K2 is launched for one level.

    ``path``: ``"smem"`` (one CTA an odd block, L, W2, the reciprocals of
    L's diagonal and, in stage 1, W1^T in shared memory) or ``"global"``
    (W2, the reciprocals and W1^T in a device workspace of ``scratch``
    elements, one slot a CTA; L read where K1 left it; each of the
    ``ctas`` CTAs takes every ``ctas``-th odd block).  ``smem_bytes`` is
    each stage's dynamic shared memory and ``ld`` the leading dimension of
    the working copies (on path "smem" rows padded by 4 elements, against
    bank conflicts, where that still fits)."""
    path: str
    ctas: int
    threads: int
    smem_bytes: tuple
    ld: int
    scratch: int


def launch_plan(m, n, dtype, sms=H100_SMS):
    """K2's launch for a level of ``m`` blocks of size ``n``, or None where
    the kernel does not take the shape: a dtype other than f64 and f32, or
    an ``n`` not a positive multiple of 8 (the band KKT's blocks are one).
    Path ``"smem"`` while three blocks fit one CTA's shared memory (f64
    n <= 96, f32 n <= 136), ``"global"`` above: two CTAs an SM, fewer where
    their slots would pass ``SCRATCH_BYTES``.  A CTA has one warp per tile
    row of the block, at most 8: stage 1's solves are twice as many warp
    tasks, one a tile column of W2 and one a tile row of W1^T."""
    if dtype not in _SYMBOLS or n % 8 or n < 8:
        return None
    esize = torch.finfo(dtype).bits // 8
    threads = 32 * min(MAX_WARPS, n // 8)
    m_odd = m // 2
    fits = [ld for ld in (n + 4, n)
            if (3 * n * ld + n) * esize <= SMEM_LIMIT - STATIC_SMEM]
    if fits:
        ld = fits[0]
        smem = ((3 * n * ld + n) * esize, (2 * n * ld + n) * esize)
        return LaunchPlan("smem", m_odd, threads, smem, ld, 0)
    slot = 2 * n * n + n
    ctas = max(1, min(m_odd, 2 * sms, SCRATCH_BYTES // (slot * esize)))
    return LaunchPlan("global", ctas, threads, (0, 0), n, ctas * slot)


def level_bytes(m, n, esize):
    """The least a level of ``m`` blocks moves: each odd block's factor and
    two couplings and each even block read once, each new block and
    coupling written once."""
    m_odd, m_even = m // 2, (m + 1) // 2
    return (3 * m_odd + 2 * m_even + m_even - 1) * n * n * esize


def _kernel(dtype):
    fn = getattr(cuda_build.load("bcr_level"), _SYMBOLS[dtype])
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _check(L, Epad, D_even, D_next, E_next):
    m_odd, n = L.shape[0], L.shape[-1]
    m, m_even = Epad.shape[0], D_even.shape[0]
    shapes = (L.shape == (m_odd, n, n) and Epad.shape == (m, n, n)
              and m_odd == m // 2 and m_even == (m + 1) // 2
              and D_even.shape == (m_even, n, n)
              and D_next.shape == (m_even, n, n)
              and (E_next is None if m_even == 1
                   else E_next is not None
                   and E_next.shape == (m_even, n, n)))
    if not shapes:
        raise ValueError("bcr_level: inconsistent level shapes")
    outs = (D_next,) if E_next is None else (D_next, E_next)
    for t in (L, Epad, D_even) + outs:
        if t.dtype != L.dtype or t.device != L.device:
            raise ValueError("bcr_level: mixed dtypes or devices")
    if L.device.type == "cpu":
        return
    # the kernel's layout
    for t in (L, Epad) + outs:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("bcr_level: L, Epad and the outputs must be "
                             "contiguous and 16-byte aligned")
    st = D_even.stride()
    if D_even.data_ptr() % 16 or st[1:] != (n, 1) or (m_even > 1 and (
            st[0] % (n * n) or st[0] <= 0)):
        raise ValueError("bcr_level: D_even must be whole blocks at a "
                         "block stride")


def bcr_level(L, Epad, D_even, D_next, E_next):
    """One level's Schur update into ``D_next`` (``m_even`` blocks, odd
    ones first) and ``E_next`` (the next level's ``Epad``, ``m_even``
    blocks with a zero tail; None when ``m_even`` is 1), from K1's factors
    ``L`` (``m_odd`` blocks), the level's ``Epad`` (``m`` blocks) and its
    even blocks ``D_even`` (a view at a block stride).  The kernel for
    CUDA tensors, two launches (its two stages); the plain version for CPU
    tensors."""
    _check(L, Epad, D_even, D_next, E_next)
    m_odd, m_even, n = L.shape[0], D_even.shape[0], L.shape[-1]
    if L.device.type == "cpu":
        D_new, E_new = bcr_level_reference(
            L, Epad[1::2], Epad[0::2][:m_odd], D_even)
        D_next[:m_even // 2] = D_new[1::2]
        D_next[m_even // 2:] = D_new[0::2]
        if E_next is not None:
            E_next[:m_even - 1] = E_new
            E_next[m_even - 1] = 0
        count("kkt.bcr_eager_levels")
        return
    if L.device.type != "cuda":
        raise ValueError(f"bcr_level: unsupported device {L.device}")
    m = Epad.shape[0]
    sms = torch.cuda.get_device_properties(L.device).multi_processor_count
    plan = launch_plan(m, n, L.dtype, sms)
    if plan is None:
        raise ValueError(f"bcr_level: no launch for blocks of {n} in "
                         f"{L.dtype}")
    fn = _kernel(L.dtype)
    stride = D_even.stride(0) // (n * n) if m_even > 1 else 1
    e_ptr = None if E_next is None else E_next.data_ptr()
    work = L.new_empty(plan.scratch) if plan.scratch else None
    scratch = None if work is None else work.data_ptr()
    stream = torch.cuda.current_stream(L.device).cuda_stream
    with torch.cuda.device(L.device):
        for stage, smem in enumerate(plan.smem_bytes, start=1):
            err = fn(L.data_ptr(), Epad.data_ptr(), D_even.data_ptr(),
                     stride, D_next.data_ptr(), e_ptr, m, n, stage,
                     plan.ctas, plan.threads, smem, plan.ld, scratch,
                     stream)
            if err != 0:
                raise RuntimeError(f"bcr_level kernel launch failed: CUDA "
                                   f"error {err}")
            bcr_level.launches += 1
    count("kkt.bcr_fused_levels")


bcr_level.launches = 0
