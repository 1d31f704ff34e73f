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
    chol_linv, chol_linv_reference)


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

