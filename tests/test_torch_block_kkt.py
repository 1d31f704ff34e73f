"""The PyTorch port's band/block KKT backend against the JAX package's on
quad-12 (band), hovercraft-41, farmer-64 (scenario blocks with a border)
and pandemic-56x10 (band with a border of 66): structure analysis (equal),
block assembly (rtol 1e-12), and factor+solve against the JAX backend and
against the port's dense backend (rtol 1e-10; test_block_kkt.py's
``_linear_system_parity`` holds the JAX backends to 1e-8) -- for
pandemic-56x10 (n = 5,346) against the JAX backend's matvec and by the
solve's residual through matvec instead of a dense matrix."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.solvers.block_tridiag import (
    BlockTridiagKKT as JBlockKKT)
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.interop import kkt_blocks_from_numpy
from infiniteexamodels_jl_torch.solvers import DenseKKT
from infiniteexamodels_jl_torch.solvers.block_tridiag import (
    BlockTridiagKKT, make_structured_kkt)
from infiniteexamodels_jl_torch.transcribe import transcribe as ttranscribe

CASES = {
    "quad12": lambda M: M.quad(num_supports=12),
    "hovercraft41": lambda M: M.hovercraft(num_supports=41),
    # scenario blocks plus the first-stage arrowhead border
    "farmer64": lambda M: M.farmer(num_scenarios=64),
    # the band with a border: the smallest pandemic grid that takes it
    # (components wider than max_block, so band mode; from 10 scenarios on
    # the shared control u(t) is the border) -- n = 5,346
    "pandemic56x10": lambda M: M.pandemic(num_supports=56,
                                          num_scenarios=10),
}
# above this n the dense (n, n) comparison is left out and the solve is
# held by its residual through matvec instead
DENSE_MAX_N = 2000
KW = dict(min_blocks=2)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    build = CASES[request.param]
    jm, _ = jtranscribe(build(jmodels))
    tm, _ = ttranscribe(build(tmodels), device="cpu")
    jb, tb = JBlockKKT(jm, **KW), BlockTridiagKKT(tm, **KW)
    assert jb.usable and tb.usable
    rng = np.random.default_rng(1)
    pt = dict(x=np.asarray(jm.x0) + 0.01 * rng.standard_normal(jm.nvar),
              lam=0.1 * rng.standard_normal(jm.ncon),
              d=rng.uniform(1.0, 3.0, jm.ncon),
              diag=rng.uniform(2.0, 4.0, jm.nvar),
              v=rng.standard_normal(jm.nvar),
              rhs=rng.standard_normal(jm.nvar))
    return jm, tm, jb, tb, pt, _assemble_both(jm, tm, jb, tb, pt)


def _assemble_both(jm, tm, jb, tb, pt):
    # jit: one XLA compile of the JAX assembly instead of op-by-op dispatch
    Kj = jax.jit(jb.assemble)(jnp.asarray(pt["x"]), jm.theta,
                              jnp.asarray(pt["lam"]), 1.0,
                              jnp.asarray(pt["d"]), jnp.asarray(pt["diag"]))
    Kt = tb.assemble(torch.as_tensor(pt["x"]), tm.theta,
                     torch.as_tensor(pt["lam"]), 1.0,
                     torch.as_tensor(pt["d"]), torch.as_tensor(pt["diag"]))
    return Kj, Kt


def test_structure_matches_jax(case):
    jm, tm, jb, tb, pt, _ = case
    assert (jb.mode, jb.nb, jb.bs, jb.mB, jb.block_diag) == \
        (tb.mode, tb.nb, tb.bs, tb.mB, tb.block_diag)
    # quad-12 is band mode; hovercraft-41 splits into two components
    # (one per axis) and takes the block-diagonal branch; farmer-64 has one
    # block per scenario and the 3 first-stage variables as its border
    # pandemic-56x10 is band mode with 66 border variables
    assert (tb.mode, tb.mB) == {8: ("band", 0), 2: ("block_diag", 0),
                                64: ("block_diag", 3),
                                330: ("band", 66)}[tb.nb]
    assert np.array_equal(jb._slot_np, tb._slot_np)
    # the assembly plans add the same value positions into each
    # destination, in the same order
    nnz = len(tm.hess_rows_np)
    for name in "DLBC":
        want = _segments(np.asarray(getattr(jb, name + "_tab")),
                         np.asarray(getattr(jb, name + "_u")), nnz)
        got = getattr(tb, name + "_plan")
        assert _plan_segments(got, nnz) == want, name
    for name in ("diag_take", "diag_dest", "slot_src", "out_perm"):
        assert np.array_equal(np.asarray(getattr(jb, name)),
                              getattr(tb, name).numpy()), name


def _segments(tab, u, sentinel):
    """{destination: value positions in summation order} of a take-table."""
    return {int(d): [int(i) for i in row if i != sentinel]
            for d, row in zip(u, tab)}


def _plan_segments(plan, sentinel):
    out = {}
    k = 0
    for tab in plan.tabs:
        out.update(_segments(tab.numpy(), plan.u[k:k + len(tab)].numpy(),
                             sentinel))
        k += len(tab)
    return out


def test_assembled_blocks_match_jax(case):
    Kj, Kt = case[-1]
    for a, b in zip(Kj, Kt):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        if a.size:
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                       atol=1e-12 * np.abs(a).max())


def test_factor_solve_match_jax_and_dense(case):
    jm, tm, jb, tb, pt, (Kj, Kt) = case
    fj, okj = jax.jit(jb.factor)(Kj)
    ft, okt = tb.factor(Kt)
    assert bool(okj) and bool(okt)
    rhs = torch.as_tensor(pt["rhs"])
    xt = tb.solve(ft, rhs).numpy()
    xj = np.asarray(jb.solve(fj, jnp.asarray(pt["rhs"])))
    np.testing.assert_allclose(xt, xj, rtol=1e-10, atol=1e-10)
    v = torch.as_tensor(pt["v"])
    if tm.nvar > DENSE_MAX_N:
        np.testing.assert_allclose(
            tb.matvec(Kt, v).numpy(),
            np.asarray(jb.matvec(Kj, jnp.asarray(pt["v"]))),
            rtol=1e-10, atol=1e-8)
        res = torch.linalg.vector_norm(tb.matvec(Kt, torch.as_tensor(xt))
                                       - rhs)
        assert float(res / torch.linalg.vector_norm(rhs)) <= 1e-12
        return
    dense = DenseKKT(tm)
    Kd = dense.assemble(torch.as_tensor(pt["x"]), tm.theta,
                        torch.as_tensor(pt["lam"]), 1.0,
                        torch.as_tensor(pt["d"]), torch.as_tensor(pt["diag"]))
    np.testing.assert_allclose(tb.matvec(Kt, v).numpy(), (Kd @ v).numpy(),
                               rtol=1e-10, atol=1e-8)
    fd, okd = dense.factor(Kd)
    assert bool(okd)
    np.testing.assert_allclose(xt, dense.solve(fd, rhs).numpy(), rtol=1e-10,
                               atol=1e-10)


def test_not_spd_gives_not_ok(case):
    jm, tm, jb, tb, pt, (Kj, Kt) = case
    D, L, B, C = Kt
    D = D.clone()
    D[1] = -torch.eye(tb.bs, dtype=D.dtype)
    _, ok = tb.factor((D, L, B, C))
    assert not bool(ok)


def test_make_structured_kkt_picks_band():
    tm, _ = ttranscribe(tmodels.quad(num_supports=12), device="cpu")
    kkt = make_structured_kkt(tm, fallback=False)
    assert isinstance(kkt, BlockTridiagKKT) and kkt.mode == "band"
    assert (kkt.nb, kkt.bs) == (8, 64)


def test_factor_solve_of_carried_across_jax_blocks(case):
    """JAX-assembled (D, L, B, C) blocks, carried across as numpy, factor
    and solve in the port to the JAX backend's answer."""
    jm, tm, jb, tb, pt, (Kj, Kt) = case
    K = kkt_blocks_from_numpy([np.asarray(a) for a in Kj], "cpu")
    ft, ok = tb.factor(K)
    fj, okj = jax.jit(jb.factor)(Kj)
    assert bool(ok) and bool(okj)
    np.testing.assert_allclose(
        tb.solve(ft, torch.as_tensor(pt["rhs"])).numpy(),
        np.asarray(jb.solve(fj, jnp.asarray(pt["rhs"]))),
        rtol=1e-8, atol=1e-8)


def test_k1_launches_per_factorization(case, monkeypatch):
    """One factorization calls K1 as often as the structure says: once in
    the block-diagonal branch, once per BCR level plus the root in band
    mode (quad-12: 8 blocks, 4; pandemic-56x10: 330 blocks, 10)."""
    from infiniteexamodels_jl_torch.solvers import block_tridiag
    jm, tm, jb, tb, pt, (Kj, Kt) = case
    calls = []
    k1 = block_tridiag._chol_linv

    def counted(D):
        calls.append(D.shape[0])
        return k1(D)
    monkeypatch.setattr(block_tridiag, "_chol_linv", counted)
    n0 = tb.factorizations
    tb.factor(Kt)
    assert tb.factorizations == n0 + 1
    assert len(calls) == tb.k1_launches_per_factorization()
    want = {8: 4, 2: 1, 64: 1, 330: 10}[tb.nb]
    assert len(calls) == want
    # every block is eliminated once: at its BCR level or at the root
    assert sum(calls) == tb.nb
