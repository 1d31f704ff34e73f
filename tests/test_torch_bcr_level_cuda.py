"""K2's CUDA kernel against its plain PyTorch version, on the card.

The kernel has no CPU mode, so every test here is marked ``cuda`` and skips
without a card.  The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider -m cuda \\
        tests/test_torch_bcr_level_cuda.py

The level shapes are quad-16000's (11,000 blocks of 64: 5,500 ... 1 odd
blocks over 14 levels) and the edges of the launch plan (1 to 8 warps, the
largest f64 and f32 blocks that fit shared memory, and the "global" path
above them).  The kernel sums in another order than cuBLAS, so it is held
to a bound on the difference relative to the level's own size, as K1's
tests hold K1, and to its own bits; its two paths to each other's bits.
"""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_torch.solvers import bcr_level
from infiniteexamodels_jl_torch.solvers.bcr_level import (
    bcr_level_reference, launch_plan)
from infiniteexamodels_jl_torch.solvers.block_tridiag import (
    _bcr_factor, _bcr_solve)
from infiniteexamodels_jl_torch.solvers.chol_linv import (
    chol_linv, chol_linv_reference, pivot_margin, scaled_pivots)
from infiniteexamodels_jl_torch.utils.timers import Recorder

# the blocks of each level of quad-16000's band, 11,000 blocks of 64
QUAD_LEVELS = [11000, 5500, 2750, 1375, 688, 344, 172, 86, 43, 22, 11, 6,
               3, 2]
TOL = {torch.float64: 1e-11, torch.float32: 1e-4}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def spd_band(nb, n, dtype, seed):
    """``(D, E)`` of a block-diagonally dominant SPD band with unit
    diagonal, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    opts = dict(dtype=torch.float64, device="cuda", generator=g)
    A = torch.randn((nb, n, n), **opts)
    D = A @ A.transpose(1, 2) / n + 4 * torch.eye(n, dtype=torch.float64,
                                                  device="cuda")
    E = 0.5 * torch.randn((nb - 1, n, n), **opts) / n ** 0.5
    s = torch.diagonal(D, dim1=1, dim2=2).rsqrt()
    D = D * s[:, :, None] * s[:, None, :]
    E = E * s[1:, :, None] * s[:-1, None, :]
    return D.to(dtype), E.to(dtype)


def both_versions(L, Epad, D_even):
    """K2's ``(D_new, E_new)`` in the plain version's layout, and the plain
    version's."""
    m_odd, m_even = L.shape[0], D_even.shape[0]
    D_next = torch.full(D_even.shape, float("nan"), dtype=L.dtype,
                        device="cuda")
    E_next = None if m_even == 1 else torch.full_like(D_next, float("nan"))
    before = bcr_level.bcr_level.launches
    bcr_level.bcr_level(L, Epad, D_even, D_next, E_next)
    torch.cuda.synchronize()
    assert bcr_level.bcr_level.launches - before == 2
    half = m_even // 2
    D_k2 = torch.empty_like(D_next)
    D_k2[1::2], D_k2[0::2] = D_next[:half], D_next[half:]
    if E_next is not None:
        assert bool((E_next[-1] == 0).all())
        E_next = E_next[:-1]
    plain = bcr_level_reference(L, Epad[1::2], Epad[0::2][:m_odd], D_even)
    return (D_k2, E_next), plain


def level(m, n, dtype, seed):
    D, E = spd_band(m, n, dtype, seed)
    Epad = torch.cat([E, E.new_zeros((1, n, n))])
    L, _, ok = chol_linv(D[1::2].contiguous())
    assert bool(ok)
    return L, Epad, D[0::2]


def rel_diff(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", QUAD_LEVELS)
def test_k2_matches_plain_version_at_quad_levels(m, dtype):
    _need_card()
    L, Epad, D_even = level(m, 64, dtype, seed=m)
    (D_k2, E_k2), (D_ref, E_ref) = both_versions(L, Epad, D_even)
    assert rel_diff(D_k2, D_ref) <= TOL[dtype]
    assert bool((D_k2 == D_k2.transpose(1, 2)).all())
    if m > 2:
        assert rel_diff(E_k2, E_ref) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,dtype", [
    (7, 8, torch.float64), (9, 24, torch.float64), (6, 40, torch.float32),
    (301, 16, torch.float32), (5, 96, torch.float64),
    (5, 136, torch.float32), (12, 128, torch.float32)])
def test_k2_matches_plain_version_at_the_plans_edges(m, n, dtype):
    _need_card()
    assert launch_plan(m, n, dtype) is not None
    L, Epad, D_even = level(m, n, dtype, seed=n)
    (D_k2, E_k2), (D_ref, E_ref) = both_versions(L, Epad, D_even)
    assert rel_diff(D_k2, D_ref) <= TOL[dtype]
    assert rel_diff(E_k2, E_ref) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [11000, 7])
def test_two_launches_bit_identical(m):
    _need_card()
    L, Epad, D_even = level(m, 64, torch.float64, seed=1)
    m_even = D_even.shape[0]
    outs = []
    for _ in range(2):
        D_next = torch.empty(D_even.shape, dtype=L.dtype, device="cuda")
        E_next = torch.empty_like(D_next)
        bcr_level.bcr_level(L, Epad, D_even, D_next, E_next)
        outs.append((D_next, E_next))
    torch.cuda.synchronize()
    assert m_even > 1
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.cuda
def test_a_block_singular_to_working_precision():
    """Odd block 1 is ``L0 L0^T`` with a last pivot of 1e-16 of its
    diagonal (its least eigenvalue about as far from 0 as round-off: the
    shape of ROADMAP 3.8's blocks; ``L0`` stands for the factor K1 leaves
    there), and its couplings are ``E = L0 G`` with G's last row zero, so
    the block's near-null vector is one of the band, which is semidefinite
    there: the exact W is G, the computed W's last row is round-off over
    1e-8.  The Gram updates stay finite, and the next level's least pivot,
    in K1's thresholds, stays within K1's ``pivot_margin`` of the plain
    version's."""
    _need_card()
    n, m, eps = 64, 5, 1e-8
    g = torch.Generator(device="cuda").manual_seed(38)
    opts = dict(dtype=torch.float64, device="cuda", generator=g)
    L, Epad, D_even = level(m, n, torch.float64, seed=38)
    L0 = torch.tril(0.2 * torch.randn((n, n), **opts) / n ** 0.5, -1)
    L0 = L0 + torch.eye(n, dtype=torch.float64, device="cuda")
    L0[-1, -1] = eps
    G1, G2 = 0.2 * torch.randn((2, n, n), **opts) / n ** 0.5
    G1[-1] = G2[-1] = 0
    L = L.clone()
    L[1] = L0
    Epad = Epad.clone()
    Epad[3] = (L0 @ G1).T          # E_odd[1]^T = L0 G1
    Epad[2] = L0 @ G2              # E_even[1] = L0 G2
    (D_k2, E_k2), (D_ref, E_ref) = both_versions(L, Epad, D_even)
    assert bool(torch.isfinite(D_k2).all())
    assert bool(torch.isfinite(E_k2).all())
    assert rel_diff(D_k2, D_ref) <= TOL[torch.float64]
    least = []
    for Dn in (D_k2, D_ref):
        Ln, _, ok = chol_linv_reference(Dn.contiguous())
        assert bool(ok)
        least.append(float(scaled_pivots(Dn, Ln).min()))
    assert least[0] >= least[1] - pivot_margin(n, torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb,n", [(11000, 64), (37, 64), (37, 104)])
def test_factorization_agrees_with_the_gram_route(nb, n, dtype):
    """A whole ``_bcr_factor`` and ``_bcr_solve`` through K2 against the
    Gram route (the parent's, which the CPU still takes): both solve the
    band to a small backward error, and their solutions agree."""
    _need_card()
    D, E = spd_band(nb, n, dtype, seed=nb)
    b = torch.randn((nb, n), dtype=dtype, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))

    def solve(D, E, b):
        with Recorder() as rec:
            levels, root, ok = _bcr_factor(D, E)
            x = _bcr_solve(levels, root, b)
        assert bool(ok)
        return x.cuda(), rec.counts

    x, counts = solve(D, E, b)
    levels = int(np.ceil(np.log2(nb)))
    assert counts == {"kkt.bcr_fused_levels": levels}
    x_ref, counts = solve(D.cpu(), E.cpu(), b.cpu())
    assert counts == {"kkt.bcr_eager_levels": levels}

    def backward_error(x):
        Tx = torch.matmul(D, x[..., None])[..., 0]
        Tx[1:] += torch.matmul(E, x[:-1, :, None])[..., 0]
        Tx[:-1] += torch.matmul(E.transpose(1, 2), x[1:, :, None])[..., 0]
        return float((Tx - b).abs().max() / (b.abs().max()
                                              + 6 * x.abs().max()))

    tol = TOL[dtype]
    assert backward_error(x) <= tol and backward_error(x_ref) <= tol
    assert rel_diff(x, x_ref) <= 100 * tol


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,dtype", [
    (7, 104, torch.float64), (600, 128, torch.float64),
    (9, 144, torch.float32), (3, 512, torch.float64)])
def test_blocks_too_large_for_shared_memory_take_the_global_path(m, n,
                                                                 dtype):
    _need_card()
    plan = launch_plan(m, n, dtype)
    assert plan.path == "global" and plan.ctas <= m // 2
    L, Epad, D_even = level(m, n, dtype, seed=n)
    (D_k2, E_k2), (D_ref, E_ref) = both_versions(L, Epad, D_even)
    assert rel_diff(D_k2, D_ref) <= TOL[dtype]
    assert bool((D_k2 == D_k2.transpose(1, 2)).all())
    if m > 2:
        assert rel_diff(E_k2, E_ref) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("m,dtype", [(11000, torch.float64), (7,
                                     torch.float64), (301, torch.float32)])
def test_the_two_paths_give_the_same_bits(m, dtype, monkeypatch):
    """The "global" path does the "smem" path's arithmetic in the same
    order: forced at quad's blocks of 64 (no shared memory allowed, so
    fewer CTAs than odd blocks at 11,000), it writes the same bits."""
    _need_card()
    L, Epad, D_even = level(m, 64, dtype, seed=m)
    outs = []
    for limit in (bcr_level.SMEM_LIMIT, 0):
        monkeypatch.setattr(bcr_level, "SMEM_LIMIT", limit)
        assert launch_plan(m, 64, dtype).path == ("smem" if limit
                                                  else "global")
        outs.append(both_versions(L, Epad, D_even)[0])
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
