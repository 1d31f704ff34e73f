"""K1's CUDA kernel against its plain PyTorch version, on the card.

The kernel has no CPU mode, so every test here is marked ``cuda`` and skips
without a card.  The file imports neither JAX nor the JAX package, so it
also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_kernels_cuda.py

The block sizes cover every path of the kernel and both sides of each
boundary between paths (``launch_plan``: CTA up to 120 in f64 and 168 in
f32, cluster above); batches of 2,048 small blocks take CTAs of fewer
warps.
"""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_torch.solvers import chol_linv as k1
from infiniteexamodels_jl_torch.solvers.chol_linv import (
    LaunchPlan, chol_linv, chol_linv_reference, launch_plan, pivot_margin,
    pivot_threshold, scaled_pivots)

SIZES = (8, 16, 24, 32, 40, 64, 120, 128, 144, 168, 176, 512)
DTYPES = [(torch.float64, 1e-10), (torch.float32, 1e-4)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _spd_batch(nb, n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nb, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


def _ill_conditioned_batch(nb, n, cond, seed=0):
    """SPD blocks with eigenvalues spread log-uniformly over [1/cond, 1]."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((nb, n, n)))
    lam = np.logspace(0.0, -np.log10(cond), n)
    D = (Q * lam[None, None, :]) @ Q.transpose(0, 2, 1)
    return 0.5 * (D + D.transpose(0, 2, 1))


def _backward_errors(D, L, Linv):
    """Per call: ||L L^T - D|| / ||D|| and ||L^{-1} L - I|| (Frobenius,
    worst block)."""
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    fact = torch.linalg.matrix_norm(L @ L.transpose(1, 2) - D)
    fact = float((fact / torch.linalg.matrix_norm(D)).max())
    inv = float(torch.linalg.matrix_norm(Linv @ L - eye).max())
    return fact, inv


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", DTYPES)
@pytest.mark.parametrize("nb,n", [(344, 64), (3, 8), (4, 120), (2, 512)]
                         + [(3, n) for n in SIZES if n not in (8, 120, 512)]
                         + [(2048, n) for n in (8, 16, 32, 40)])
def test_kernel_matches_plain_version_on_card(nb, n, dtype, rtol):
    _need_card()
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
    assert bool((torch.triu(L, 1) == 0).all())
    assert bool((torch.triu(Linv, 1) == 0).all())


@pytest.mark.cuda
def test_kernel_not_spd_block_on_card():
    _need_card()
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb,n", [(3, n) for n in (8, 16, 32, 64, 120, 168,
                                                   176, 512)]
                         + [(2048, 16)])
def test_pivot_failing_inside_a_diagonal_tile(nb, n, dtype):
    """Block 1's pivot n/2 + 3 (the middle of a diagonal tile; past the
    first panel from n = 16 on) is -1: the whole block is NaN and ok is
    False; the other blocks are untouched."""
    _need_card()
    p = n // 2 + 3
    D = _spd_batch(nb, n, seed=n)
    Lf = np.linalg.cholesky(D[1])
    D[1, p, p] -= Lf[p, p] ** 2 + 1.0
    D = torch.as_tensor(D, dtype=dtype, device="cuda")
    L, Linv, ok = chol_linv(D)
    Lr, Linvr, okr = chol_linv_reference(D)
    torch.cuda.synchronize()
    assert not bool(ok) and not bool(okr)
    assert bool(torch.isnan(L[1]).all()) and bool(torch.isnan(Linv[1]).all())
    keep = [0] + list(range(2, nb))
    assert bool(torch.isfinite(L[keep]).all())
    assert bool(torch.isfinite(Linv[keep]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 64, 144, 512])
def test_two_launches_bit_identical(n):
    _need_card()
    D = torch.as_tensor(_spd_batch(5, n, seed=9), device="cuda")
    a = chol_linv(D)
    b = chol_linv(D)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24, 64, 120, 128, 512])
def test_backward_error_ill_conditioned(n):
    """cond(D) = 1e8, the condensed KKT's scale: an elementwise comparison
    proves nothing there, so hold the kernel's backward errors to 10x the
    plain version's own."""
    _need_card()
    D = torch.as_tensor(_ill_conditioned_batch(4, n, 1e8, seed=n),
                        device="cuda")
    L, Linv, ok = chol_linv(D)
    Lr, Linvr, okr = chol_linv_reference(D)
    torch.cuda.synchronize()
    assert bool(ok) and bool(okr)
    fact, inv = _backward_errors(D, L, Linv)
    fact_r, inv_r = _backward_errors(D, Lr, Linvr)
    assert fact <= 10 * fact_r, (fact, fact_r)
    assert inv <= 10 * inv_r, (inv, inv_r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plan_launches_on_card(dtype):
    """Every block size takes its planned path without a refused launch."""
    _need_card()
    for n in range(8, 513, 8):
        D = torch.as_tensor(_spd_batch(1, n, seed=n), dtype=dtype,
                            device="cuda")
        _, _, ok = chol_linv(D)
        assert bool(ok), (n, launch_plan(n, dtype, 1))


def _near_indefinite_batch(n, dtype, seed):
    """Blocks ``L0 L0^T + p e_n e_n^T`` with ``L0`` lower triangular from a
    seed (diagonal in [0.5, 1] but its last entry 0, entries below the
    diagonal under 1 / n so that the leading part is well conditioned, the
    last row of unit norm so that D_nn = 1), the product taken in extended
    precision, then rounded to ``dtype``: the last pivot is p, set to s
    thresholds (``pivot_threshold(n, dtype) * D_nn``) for 33 values of s
    from -3 sqrt(n) to 3 sqrt(n).  Blocks with |s| <= ``pivot_margin(n,
    dtype)`` + 1 have a last pivot within round-off of the threshold or of
    zero, whose computed sign depends on the order of the sums; the others
    are clearly SPD or clearly not (farther from zero than any pivot's
    worst rounding error, n u D_nn, plus the threshold).  Returns the
    blocks and s."""
    rng = np.random.default_rng(seed)
    s = np.linspace(-3.0, 3.0, 33) * np.sqrt(n)
    L0 = np.tril(rng.uniform(-1.0, 1.0, (s.size, n, n)), -1) / n
    L0[:, np.arange(n), np.arange(n)] = rng.uniform(0.5, 1.0, (s.size, n))
    L0[:, -1, -1] = 0.0
    L0[:, -1] /= np.linalg.norm(L0[:, -1], axis=-1, keepdims=True)
    Ll = L0.astype(np.longdouble)
    D = np.einsum("bik,bjk->bij", Ll, Ll)
    D[:, -1, -1] += s * pivot_threshold(n, dtype)
    D = 0.5 * (D + D.transpose(0, 2, 1))
    return torch.as_tensor(D.astype(np.float64), dtype=dtype), s


def _launch(D, path):
    """K1 on ``D`` through its C entry point on ``path`` ("cta": the
    wrapper's plan; "cluster": 8 CTAs a block, whatever ``n``)."""
    nb, n = D.shape[0], D.shape[-1]
    plan = (launch_plan(n, D.dtype, nb) if path == "cta"
            else LaunchPlan("cluster", 8, 256, 0, n))
    assert plan.path == path
    L, X = torch.empty_like(D), torch.empty_like(D)
    okb = torch.empty(nb, dtype=torch.int32, device=D.device)
    err = k1._kernel(D.dtype)(
        D.data_ptr(), L.data_ptr(), X.data_ptr(), okb.data_ptr(), nb, n,
        k1._PATH_IDS[plan.path], plan.ctas, plan.threads, plan.smem_bytes,
        plan.ld, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return L, X, okb.bool()


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["cta", "cluster"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [8, 24, 64])
def test_pivot_test_on_near_indefinite_blocks(n, dtype, path):
    """K1's pivot test (``chol_linv.pivot_threshold``: a block fails when
    some pivot p_j <= 2 n u D_jj in f64, sqrt(n) u D_jj in f32) against
    LAPACK's (p_j <= 0, the plain version) on blocks whose least pivot is
    round-off of either sign.  The clearly indefinite blocks fail in both,
    the clearly SPD ones factor in both; in the band between, every block
    K1 factors passes its test by its own pivots, every block it fails is
    NaN throughout, and a block that one version factors and the other
    fails has the factoring side's least pivot within ``pivot_margin(n,
    dtype)`` thresholds (the stated margin).  In f64 K1 factors no block
    that the plain version fails."""
    _need_card()
    D, t = _near_indefinite_batch(n, dtype, seed=1000 + n)
    D = D.to("cuda").contiguous()
    L, X, okb = _launch(D, path)
    Lr, Xr, _ = chol_linv_reference(D)
    torch.cuda.synchronize()
    fin = torch.isfinite(L).flatten(1).all(1) & \
        torch.isfinite(X).flatten(1).all(1)
    nan = torch.isnan(L).flatten(1).all(1) & torch.isnan(X).flatten(1).all(1)
    fin_r = torch.isfinite(Lr).flatten(1).all(1)
    assert torch.equal(okb, fin) and torch.equal(~okb, nan)
    margin = pivot_margin(n, dtype)
    clear = np.abs(t) > margin + 1
    clear_bad = torch.as_tensor(clear & (t < 0))
    clear_good = torch.as_tensor(clear & (t > 0))
    assert bool(clear_bad.any()) and bool(clear_good.any())
    assert not bool(okb[clear_bad].any()) and not bool(fin_r[clear_bad].any())
    assert bool(okb[clear_good].all()) and bool(fin_r[clear_good].all())
    rho = scaled_pivots(D, L).cpu()
    rho_r = scaled_pivots(D, Lr).cpu()
    okb, fin_r = okb.cpu(), fin_r.cpu()
    assert bool((rho[okb] > 1 - 1e-3).all()), rho[okb].min()
    only_k1, only_plain = okb & ~fin_r, ~okb & fin_r
    if dtype == torch.float64:
        assert not bool(only_k1.any()), rho[only_k1]
    assert bool((rho[only_k1] <= margin).all()), rho[only_k1]
    assert bool((rho_r[only_plain] <= margin).all()), rho_r[only_plain]
    band = torch.as_tensor(~clear)
    # the band exercises both outcomes of the test
    assert bool(okb[band].any()) and bool((~okb[band]).any())
    print({"n": n, "dtype": str(dtype), "path": path,
           "k1_failed": int((~okb).sum()), "plain_failed":
           int((~fin_r).sum()), "only_k1_factored": int(only_k1.sum()),
           "only_plain_factored": int(only_plain.sum()),
           "threshold": pivot_threshold(n, dtype)})
