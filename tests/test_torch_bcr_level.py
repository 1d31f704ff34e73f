"""K2's plain version, its launch plan and the BCR factorization's one
route, on the CPU.

- :func:`bcr_level_reference` is the Gram-form level that ``_bcr_factor``
  ran before K2, bit for bit;
- ``launch_plan`` takes every block size the band KKT makes (a multiple
  of 8) into K2, on path "smem" while three blocks fit a CTA's shared
  memory and on path "global" above, and leaves other shapes and dtypes
  out;
- ``_bcr_factor`` always goes through :func:`bcr_level.bcr_level` (here
  the plain version into K2's layout: the next level's blocks odd ones
  first, the couplings written into the next ``Epad`` with their zero
  tail) and factors and solves a band bit for bit as the parent's Gram
  loop did, on new memory and in a placement;
- the counters ``kkt.bcr_fused_levels`` and ``kkt.bcr_eager_levels`` count
  one per level by route, and every solve carries both;
- the benchmark's ``kkt.bcr_fused_share`` reads them.

The kernel itself runs only on the card: tests/test_torch_bcr_level_cuda.py.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import registry
from infiniteexamodels_jl_torch.solvers import bcr_level, block_tridiag, ipm
from infiniteexamodels_jl_torch.solvers.bcr_level import (
    BCR_COUNTERS, LaunchPlan, bcr_level_reference, launch_plan)
from infiniteexamodels_jl_torch.solvers.block_tridiag import (
    _bcr_factor, _bcr_solve, _Placement)
from infiniteexamodels_jl_torch.utils.timers import Recorder


def spd_band(nb, bs, dtype, seed):
    """Diagonal blocks ``D`` (nb, bs, bs) and couplings ``E`` (nb-1, bs,
    bs) of a block-diagonally dominant SPD band, unit diagonal."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nb, bs, bs))
    D = A @ A.transpose(0, 2, 1) / bs + 4 * np.eye(bs)
    E = 0.5 * rng.standard_normal((nb - 1, bs, bs)) / np.sqrt(bs)
    s = 1 / np.sqrt(np.diagonal(D, axis1=1, axis2=2))
    D = D * s[:, :, None] * s[:, None, :]
    E = E * s[1:, :, None] * s[:-1, None, :]
    return (torch.as_tensor(D, dtype=dtype),
            torch.as_tensor(E, dtype=dtype))


def gram_level(D, Epad, L):
    """A level's Schur update as ``_bcr_factor`` wrote it before K2."""
    m = D.shape[0]
    m_odd, m_even = m // 2, (m + 1) // 2
    E_odd = Epad[1::2]
    E_even = Epad[0::2][:m_odd]
    W1 = torch.linalg.solve_triangular(L, E_odd.transpose(-1, -2),
                                       upper=False)
    W2 = torch.linalg.solve_triangular(L, E_even, upper=False)
    D_new = D[0::2].clone()
    Lc = torch.matmul(W1.transpose(-1, -2), W1)
    D_new[1:] -= Lc[:m_even - 1]
    Rc = torch.matmul(W2.transpose(-1, -2), W2)
    D_new[:m_odd] -= Rc
    if m_even > 1:
        E = -torch.matmul(W1.transpose(-1, -2), W2)[:m_even - 1]
    else:
        E = D.new_zeros((0,) + D.shape[1:])
    return D_new, E


def level_inputs(m, bs, dtype, seed=3):
    D, E = spd_band(m, bs, dtype, seed)
    Epad = torch.cat([E, E.new_zeros((1, bs, bs))])
    L = torch.linalg.cholesky(D[1::2])
    return D, Epad, L


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bs", [8, 24, 64])
@pytest.mark.parametrize("m", [2, 3, 6, 7])
def test_plain_version_is_the_gram_form_bit_for_bit(m, bs, dtype):
    D, Epad, L = level_inputs(m, bs, dtype)
    m_odd = m // 2
    D_new, E_new = bcr_level_reference(L, Epad[1::2], Epad[0::2][:m_odd],
                                       D[0::2])
    D_ref, E_ref = gram_level(D, Epad, L)
    assert torch.equal(D_new, D_ref)
    assert torch.equal(E_new, E_ref)
    assert E_new.shape[0] == (m + 1) // 2 - 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [2, 3, 6, 7])
def test_the_wrapper_writes_the_kernels_layout(m, dtype):
    bs = 16
    D, Epad, L = level_inputs(m, bs, dtype, seed=4)
    m_even = (m + 1) // 2
    D_next = D.new_full((m_even, bs, bs), float("nan"))
    E_next = (None if m_even == 1
              else D.new_full((m_even, bs, bs), float("nan")))
    bcr_level.bcr_level(L, Epad, D[0::2], D_next, E_next)
    D_ref, E_ref = gram_level(D, Epad, L)
    half = m_even // 2
    assert torch.equal(D_next[:half], D_ref[1::2])
    assert torch.equal(D_next[half:], D_ref[0::2])
    if E_next is not None:
        assert torch.equal(E_next[:-1], E_ref)
        assert bool((E_next[-1] == 0).all())


def test_the_wrapper_refuses_inconsistent_levels():
    D, Epad, L = level_inputs(7, 8, torch.float64)
    with pytest.raises(ValueError):
        bcr_level.bcr_level(L, Epad[:6], D[0::2], D[:4].clone(),
                            D[:4].clone())
    with pytest.raises(ValueError):     # m_even > 1 needs E_next
        bcr_level.bcr_level(L, Epad, D[0::2], D[:4].clone(), None)


@pytest.mark.parametrize("n,dtype,plan", [
    (64, torch.float64, LaunchPlan("smem", 5500, 256, (104960, 70144), 68,
                                   0)),
    (24, torch.float64, LaunchPlan("smem", 5500, 96, (16320, 10944), 28,
                                   0)),
    (8, torch.float32, LaunchPlan("smem", 5500, 32, (1184, 800), 12, 0)),
    (96, torch.float64, LaunchPlan("smem", 5500, 256, (231168, 154368), 100,
                                   0)),
    (136, torch.float32, LaunchPlan("smem", 5500, 256, (229024, 152864),
                                    140, 0)),
    # three blocks do not fit: the workspace, two CTAs an SM
    (104, torch.float64, LaunchPlan("global", 264, 256, (0, 0), 104,
                                    264 * 21736)),
    (144, torch.float32, LaunchPlan("global", 264, 256, (0, 0), 144,
                                    264 * 41616)),
    # ... fewer where the slots would pass SCRATCH_BYTES
    (512, torch.float64, LaunchPlan("global", 63, 256, (0, 0), 512,
                                    63 * 524800)),
    (12, torch.float64, None),            # not a multiple of 8
    (64, torch.float16, None),
    (64, torch.bfloat16, None)])
def test_launch_plan_by_shape_and_dtype(n, dtype, plan):
    got = launch_plan(11000, n, dtype)
    assert got == plan
    if got is None:
        return
    assert got.ld % 4 == 0 and got.threads % 32 == 0
    esize = torch.finfo(dtype).bits // 8
    if got.path == "smem":
        assert max(got.smem_bytes) + bcr_level.STATIC_SMEM <= \
            bcr_level.SMEM_LIMIT
    else:
        assert got.scratch * esize <= bcr_level.SCRATCH_BYTES


@pytest.mark.parametrize("m,ctas", [(2, 1), (3, 1), (4, 2), (11, 5),
                                    (1, 0)])
def test_launch_plan_takes_a_cta_an_odd_block(m, ctas):
    assert launch_plan(m, 64, torch.float64).ctas == ctas


@pytest.mark.parametrize("m,ctas", [(2, 1), (5, 2), (600, 264),
                                    (100001, 264)])
def test_the_global_path_caps_its_grid(m, ctas):
    plan = launch_plan(m, 128, torch.float64)
    assert plan.path == "global" and plan.ctas == ctas
    assert plan.scratch == ctas * (2 * 128 * 128 + 128)


def gram_factor(D, E):
    """The parent's ``_bcr_factor`` loop: K1's plain version and the Gram
    level, every level concatenating its couplings with a zero block."""
    from infiniteexamodels_jl_torch.solvers.chol_linv import (
        chol_linv_reference)
    levels = []
    while D.shape[0] > 1:
        m = D.shape[0]
        L, Linv, _ = chol_linv_reference(D[1::2].contiguous())
        Epad = torch.cat([E, E.new_zeros((1,) + D.shape[1:])])
        levels.append((Linv, Epad[1::2], Epad[0::2][:m // 2]))
        D, E = gram_level(D, Epad, L)
    return levels, chol_linv_reference(D.contiguous())[1]


def factor_and_solve(D, E, b, place=None):
    with Recorder() as rec:
        levels, root, ok = _bcr_factor(D, E, place)
        x = _bcr_solve(levels, root, b)
    return levels, root, ok, x, rec.counts


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb,bs", [(2, 8), (3, 8), (11, 16), (16, 24),
                                   (37, 8)])
def test_k2_route_factors_and_solves_as_the_gram_route(nb, bs, dtype):
    D, E = spd_band(nb, bs, dtype, seed=nb)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal((nb, bs)),
                        dtype=dtype)
    lv0, r0 = gram_factor(D, E)
    x0 = _bcr_solve(lv0, r0, b)
    for place in (None, _Placement()):
        for _ in range(2):         # the second reuses the placement
            lv1, r1, ok1, x1, c1 = factor_and_solve(D, E, b, place)
            assert bool(ok1)
            assert torch.equal(r0, r1) and torch.equal(x0, x1)
            for a, c in zip(lv0, lv1):
                assert all(torch.equal(u, v) for u, v in zip(a, c))
    levels = len(lv0)
    assert c1 == {"kkt.bcr_eager_levels": levels}
    assert levels == int(np.ceil(np.log2(nb)))
    # the placement holds each level's couplings, the graph's inputs
    for lvl, (_, E_odd, _) in enumerate(lv1):
        assert E_odd.data_ptr() == place.bufs[("Epad", lvl)][1:].data_ptr()


def test_every_solve_carries_both_counters():
    assert set(BCR_COUNTERS) <= set(ipm.ZEROED_COUNTS)
    assert block_tridiag.bcr_level is bcr_level


@pytest.mark.parametrize("counts,share", [
    ({}, None),                                   # a program without them
    ({"kkt.bcr_fused_levels": 0, "kkt.bcr_eager_levels": 0}, None),
    ({"kkt.bcr_eager_levels": 14}, 0.0),
    ({"kkt.bcr_fused_levels": 14, "kkt.bcr_eager_levels": 0}, 1.0),
    ({"kkt.bcr_fused_levels": 3, "kkt.bcr_eager_levels": 1}, 0.75)])
def test_the_fused_share_reads_the_counters(counts, share):
    res = SimpleNamespace(iter=13, spans={"ipm.solve": {}}, counts=counts)
    solver = SimpleNamespace(results=res)
    run = SimpleNamespace(system=SimpleNamespace(solver=lambda: solver))
    assert registry.reader("kkt.bcr_fused_share")(run) == share
