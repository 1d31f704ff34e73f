"""K1's CUDA kernel against its plain PyTorch version, on the card.

The kernel has no CPU mode, so every test here is marked ``cuda`` and skips
without a card.  The file imports neither JAX nor the JAX package, so it
also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_torch.solvers.chol_linv import (
    chol_linv, chol_linv_reference)


def _spd_batch(nb, n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nb, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("nb,n", [(344, 64), (3, 8), (4, 120), (2, 512)])
def test_kernel_matches_plain_version_on_card(nb, n, dtype, rtol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    D = torch.as_tensor(_spd_batch(nb, n, seed=5), dtype=dtype,
                        device="cuda").contiguous()
    before = chol_linv.launches
    L, Linv, ok = chol_linv(D)
    Lr, Linvr, okr = chol_linv_reference(D)
    torch.cuda.synchronize()
    assert chol_linv.launches == before + 1
    assert bool(ok) and bool(okr)
    scale = float(Linvr.abs().max())
    assert float((L - Lr).abs().max()) <= rtol * float(Lr.abs().max())
    assert float((Linv - Linvr).abs().max()) <= rtol * scale


@pytest.mark.cuda
def test_kernel_not_spd_block_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    D = torch.as_tensor(_spd_batch(4, 64, seed=6), device="cuda")
    D[2] = -torch.eye(64, dtype=D.dtype, device="cuda")
    L, Linv, ok = chol_linv(D)
    Lr, _, okr = chol_linv_reference(D)
    torch.cuda.synchronize()
    assert not bool(ok) and not bool(okr)
    assert bool(torch.isnan(L[2]).all()) and bool(torch.isnan(Linv[2]).all())
    keep = [0, 1, 3]
    assert float((L[keep] - Lr[keep]).abs().max()) <= 1e-10 * float(
        Lr[keep].abs().max())
