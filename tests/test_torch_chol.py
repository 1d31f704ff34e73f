"""K1 (``chol_linv``): the plain PyTorch version against the JAX package's
``_chol_linv`` (f64, XLA) and the Pallas kernel in interpret mode (f32), the
NaN/ok contract, and the wrapper's checks.  The CUDA kernel itself runs only
on the card: tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu.solvers.block_tridiag import (
    _chol_linv as jax_chol_linv)
from infiniteexamodels_jl_tpu.solvers.pallas_chol import chol_linv_pallas
from infiniteexamodels_jl_torch.solvers.chol_linv import (
    CTA_THREADS, MAX_THREADS, SMEM_LIMIT, STATIC_SMEM, chol_linv,
    chol_linv_reference, launch_plan)


def _spd_batch(nb, n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nb, n, n)).astype(dtype)
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=dtype))


@pytest.mark.parametrize("nb,n", [(1, 8), (3, 16), (17, 24), (8, 64)])
def test_reference_matches_jax_f64(nb, n):
    D = _spd_batch(nb, n)
    Lj, Linvj, okj = jax_chol_linv(jnp.asarray(D))
    L, Linv, ok = chol_linv(torch.as_tensor(D))
    assert bool(okj) and bool(ok)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-12,
                               atol=1e-12 * np.abs(np.asarray(Lj)).max())
    eye = np.broadcast_to(np.eye(n), (nb, n, n))
    assert np.abs(Linv.numpy() @ L.numpy() - eye).max() <= 1e-10
    assert np.allclose(np.triu(L.numpy(), 1), 0.0)
    assert np.allclose(np.triu(Linv.numpy(), 1), 0.0)
    np.testing.assert_allclose(Linv.numpy(), np.asarray(Linvj), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("nb,n", [(1, 8), (3, 16), (17, 24)])
def test_reference_matches_pallas_interpret_f32(nb, n):
    D = _spd_batch(nb, n, dtype=np.float32)
    Lp, Linvp, okp = chol_linv_pallas(jnp.asarray(D), interpret=True)
    L, Linv, ok = chol_linv(torch.as_tensor(D))
    assert bool(okp) and bool(ok) and L.dtype == torch.float32
    # tolerances of the Pallas kernel's own test (f32 conditioning)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lp), rtol=2e-4,
                               atol=2e-4)
    Lx = np.linalg.cholesky(D.astype(np.float64))
    eye = np.broadcast_to(np.eye(n), (nb, n, n))
    np.testing.assert_allclose(Linv.numpy() @ Lx, eye, atol=5e-4)
    np.testing.assert_allclose(Linv.numpy(), np.asarray(Linvp), rtol=2e-3,
                               atol=2e-4)


def test_not_spd_block_flags_not_ok():
    D = _spd_batch(4, 8, seed=1)
    D[2] = -np.eye(8)
    _, Linvj, okj = jax_chol_linv(jnp.asarray(D))
    _, _, okp = chol_linv_pallas(jnp.asarray(D.astype(np.float32)),
                                 interpret=True)
    L, Linv, ok = chol_linv(torch.as_tensor(D))
    assert not bool(okj) and not bool(okp) and not bool(ok)
    # the failed block is NaN (as the JAX function's), the others are not
    assert torch.isnan(L[2]).all() and torch.isnan(Linv[2]).all()
    assert np.isnan(np.asarray(Linvj)[2]).all()
    assert torch.isfinite(Linv[[0, 1, 3]]).all()


def test_cpu_tensor_takes_the_plain_version():
    D = torch.as_tensor(_spd_batch(3, 16))
    before = chol_linv.launches
    out = chol_linv(D)
    ref = chol_linv_reference(D)
    assert chol_linv.launches == before     # no kernel launch on the CPU
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad,err", [
    (lambda: torch.zeros(3, 8, 8, dtype=torch.float16), TypeError),
    (lambda: torch.zeros(3, 8, 8, dtype=torch.int64), TypeError),
    (lambda: torch.zeros(8, 8, dtype=torch.float64), ValueError),
    (lambda: torch.zeros(3, 8, 16, dtype=torch.float64), ValueError),
    (lambda: torch.zeros(3, 12, 12, dtype=torch.float64), ValueError),
    (lambda: torch.zeros(1, 520, 520, dtype=torch.float64), ValueError),
    (lambda: torch.zeros(3, 16, 16, dtype=torch.float64)[:, ::2, ::2],
     ValueError),
    (lambda: torch.zeros(3, 8, 8, dtype=torch.float64, device="meta"),
     ValueError),
])
def test_wrapper_rejects(bad, err):
    with pytest.raises(err):
        chol_linv(bad())




# the documented boundaries: CTA while a block and its inverse fit in
# shared memory, cluster above
_CTA_MAX_N = {torch.float64: 120, torch.float32: 168}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", range(8, 513, 8))
def test_launch_plan_fits_the_card(n, dtype):
    """The kernel's launch configuration for every block size and batches
    from one block to many waves: within 227 KB of shared memory (a launch
    that asks for more is refused and never runs) and 1,024 threads, on
    the documented path."""
    esize = torch.finfo(dtype).bits // 8
    for nb in (1, 16, 344, 2048, 100000):
        plan = launch_plan(n, dtype, nb)
        assert 32 <= plan.threads <= min(1024, MAX_THREADS)
        assert plan.threads in CTA_THREADS
        assert plan.smem_bytes + STATIC_SMEM <= SMEM_LIMIT == 232448
        assert plan.ld >= n
        assert plan.path == ("cta" if n <= _CTA_MAX_N[dtype] else "cluster")
        if plan.path == "cluster":
            assert plan.smem_bytes == 0 and plan.ld == n
            assert plan.ctas in (8, 16) and plan.threads == MAX_THREADS
        else:
            assert plan.ctas == 1
            assert plan.smem_bytes >= 2 * n * plan.ld * esize


@pytest.mark.parametrize("n,dtype,nb,threads", [
    (64, torch.float64, 344, 256),    # quad-1000's first BCR level
    (64, torch.float64, 1, 256),
    (8, torch.float64, 16, 256),      # one wave: 8 warps a block
    (8, torch.float64, 2048, 32),     # one wave only with 1 warp a block
    (24, torch.float32, 2048, 32),
    (32, torch.float32, 2048, 32),
    (32, torch.float64, 2048, 128),   # several waves whatever the count
    (64, torch.float32, 2048, 128),
    (64, torch.float64, 2048, 256),
    (8, torch.float64, 100000, 32),
])
def test_launch_plan_warps_follow_the_batch(n, dtype, nb, threads):
    """Path "cta" gives a block the most warps with which the batch runs in
    one wave on the H100's 132 SMs, else the fewest waves (at least 4
    warps from n = 32 on): the choices k1_sweep timed best."""
    plan = launch_plan(n, dtype, nb)
    assert plan.path == "cta" and plan.threads == threads
