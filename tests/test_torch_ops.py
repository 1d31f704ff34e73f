"""tests/test_ops.py through the port on the CPU: the SIMD core's shapes and
offsets, evaluation and AD (gradient, Jacobian, Hessian), parameters,
nonlinear ops and iterator fields, the product iterator's order, the
objective sense, and the matrix-free Lagrangian Hessian-vector product;
each evaluation against its closed form and against the JAX package's on
the same toy.  The JAX file's ``test_slot_aliasing_hessian`` is ported as
tests/test_torch_simd.py::test_slot_aliasing_hessian."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu import ops as jops
from infiniteexamodels_jl_tpu.models import quad as jquad
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch import ops as tops
from infiniteexamodels_jl_torch.models import quad
from infiniteexamodels_jl_torch.transcribe import transcribe


def build_toy(P):
    """min sum_i (x[i] - t_i)^2  s.t.  x[i] - x[i-1] == 0.1, plus a finite
    var z with  z * x[2] >= 1 (``P`` is either package's ``ops``)."""
    core = P.Core()
    n = 5
    t = np.linspace(0.0, 1.0, n)
    x = core.add_var((n,), start=1.0, name="x")
    z = core.add_var((), lvar=0.5, name="z")
    itr = P.Iterator({"i": np.arange(n), "t": t})
    core.add_obj(P.abs2(x[P.SRC.i] - P.SRC.t), itr)
    step = P.Iterator({"i": np.arange(1, n)})
    core.add_con(x[P.SRC.i] - x[P.SRC.i - 1], step, lcon=0.1, ucon=0.1)
    core.add_con(z.entry() * x[2], lcon=1.0, ucon=np.inf)
    return core, x, z, t


def toys():
    """The toy built in both packages: (port model, JAX model, t)."""
    core, _, _, t = build_toy(tops)
    jcore, _, _, _ = build_toy(jops)
    return core.build(device="cpu"), jcore.build(), t


XV = np.concatenate([np.arange(5.0) * 0.1, [2.0]])


def test_shapes_and_offsets():
    core, x, z, t = build_toy(tops)
    assert core.nvar == 6
    assert x.offset == 0 and z.offset == 5
    assert core.ncon == 5
    m = core.build(device="cpu")
    assert m.lcon.shape == (5,)
    np.testing.assert_allclose(m.lcon.numpy(), [0.1] * 4 + [1.0])
    np.testing.assert_allclose(m.x0.numpy(), [1.0] * 5 + [0.0])
    np.testing.assert_allclose(m.lvar.numpy()[5], 0.5)


def test_eval_and_ad():
    m, jm, t = toys()
    xv, th = torch.as_tensor(XV), m.theta
    obj = float(m.obj(xv, th))
    assert obj == pytest.approx(float(np.sum((np.arange(5) * 0.1 - t) ** 2)))
    assert obj == pytest.approx(float(jm.obj(jnp.asarray(XV), jm.theta)),
                                rel=1e-15)
    c = m.cons(xv, th).numpy()
    np.testing.assert_allclose(c[:4], 0.1)
    assert c[4] == pytest.approx(2.0 * 0.2)
    g = m.grad(xv, th).numpy()
    np.testing.assert_allclose(g[:5], 2 * (np.arange(5) * 0.1 - t),
                               atol=1e-12)
    assert g[5] == 0.0
    np.testing.assert_array_equal(
        g, np.asarray(jm.grad(jnp.asarray(XV), jm.theta)))
    jv = m.jac_vals(xv, th).numpy()
    J = np.zeros((m.ncon, m.nvar))
    np.add.at(J, (m.jac_rows_np, m.jac_cols_np), jv)
    Jtrue = np.zeros_like(J)
    for r, i in enumerate(range(1, 5)):
        Jtrue[r, i] = 1.0
        Jtrue[r, i - 1] = -1.0
    Jtrue[4, 2] = 2.0   # z * x[2], z = 2
    Jtrue[4, 5] = 0.2   # x[2] = 0.2
    np.testing.assert_allclose(J, Jtrue, atol=1e-12)
    np.testing.assert_array_equal(
        jv, np.asarray(jm.jac_vals(jnp.asarray(XV), jm.theta)))


def test_hessian_assembly():
    m, jm, _ = toys()
    lam = np.array([0.0, 0.0, 0.0, 0.0, 3.0])
    hv = m.hess_vals(torch.as_tensor(XV), m.theta, torch.as_tensor(lam),
                     1.0).numpy()
    H = np.zeros((m.nvar, m.nvar))
    np.add.at(H, (m.hess_rows_np, m.hess_cols_np), hv)
    Htrue = np.zeros_like(H)
    Htrue[np.arange(5), np.arange(5)] = 2.0        # objective sum (x-t)^2
    Htrue[2, 5] = Htrue[5, 2] = 3.0                # lam * d2(z*x2)
    np.testing.assert_allclose(H, Htrue, atol=1e-12)
    np.testing.assert_array_equal(hv, np.asarray(jm.hess_vals(
        jnp.asarray(XV), jm.theta, jnp.asarray(lam), 1.0)))


def test_parameters_and_update():
    core = tops.Core()
    x = core.add_var((), name="x")
    p = core.add_par([3.0], name="p")
    core.add_obj(tops.abs2(x.entry() - p[0]))
    m = core.build(device="cpu")
    xv = torch.tensor([1.0], dtype=torch.float64)
    assert float(m.obj(xv, m.theta)) == pytest.approx(4.0)
    m.set_parameter(p, [5.0])
    assert float(m.obj(xv, m.theta)) == pytest.approx(16.0)


def test_nonlinear_ops_and_fields():
    core = tops.Core()
    n = 4
    x = core.add_var((n,), name="x")
    itr = tops.Iterator({"i": np.arange(n), "c": np.full(n, 0.25),
                         "t": np.linspace(0, 1, n)})
    core.add_obj(tops.SRC.c * tops.sin(x[tops.SRC.i]) * tops.SRC.t, itr)
    m = core.build(device="cpu")
    xv = np.linspace(0.5, 2.0, n)
    expected = np.sum(0.25 * np.sin(xv) * np.linspace(0, 1, n))
    assert float(m.obj(torch.as_tensor(xv), m.theta)) == pytest.approx(
        float(expected))


def test_iterator_product_order():
    a = tops.Iterator({"i": np.arange(2), "t": np.array([0.0, 1.0])})
    b = tops.Iterator({"j": np.arange(3), "s": np.array([5.0, 6.0, 7.0])})
    p = tops.Iterator.product(a, b)
    assert len(p) == 6
    # C-order: the last iterator varies fastest
    np.testing.assert_array_equal(p["i"], [0, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(p["j"], [0, 1, 2, 0, 1, 2])
    np.testing.assert_array_equal(p["s"], [5, 6, 7, 5, 6, 7])


def test_maximize_sense():
    core = tops.Core(minimize=False)
    x = core.add_var((), name="x")
    core.add_obj(-tops.abs2(x.entry() - 2.0))
    m = core.build(device="cpu")
    assert m.sense == -1.0


def test_hvp_lag_matches_dense_hessian():
    """hvp_lag equals the densified hess_vals Hessian applied to the same
    vector (quad-7: constraint and objective curvature, slot aliasing), and
    the JAX package's hvp_lag at the same point."""
    m, _ = transcribe(quad(num_supports=7), device="cpu")
    jm, _ = jtranscribe(jquad(num_supports=7))
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 0.2, m.nvar)
    v = rng.normal(size=m.nvar)
    lam = rng.normal(size=m.ncon)
    sigma = 1.3
    T = torch.as_tensor
    hv = m.hvp_lag(T(x), m.theta, T(lam), sigma, T(v)).numpy()
    vals = m.hess_vals(T(x), m.theta, T(lam), sigma).numpy()
    H = np.zeros((m.nvar, m.nvar))
    np.add.at(H, (m.hess_rows_np, m.hess_cols_np), vals)
    np.testing.assert_allclose(hv, H @ v, rtol=1e-10, atol=1e-10)
    jhv = np.asarray(jm.hvp_lag(jnp.asarray(x), jm.theta, jnp.asarray(lam),
                                sigma, jnp.asarray(v)))
    np.testing.assert_allclose(hv, jhv, rtol=1e-12, atol=1e-12)
