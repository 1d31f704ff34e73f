"""tests/test_solve_parity.py through the port on the CPU: the reference's
solver-verified oracles (test/solve.jl, test/ipopt.jl) at the JAX test's
tolerance (atol 1e-6), and where the JAX test has no oracle, the objective
the JAX package reaches on the same model."""
import numpy as np
import pytest

from infiniteexamodels_jl_tpu import modeling as jmodeling
from infiniteexamodels_jl_tpu.backend import (
    ExaTranscriptionBackend as JBackend)
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver
from infiniteexamodels_jl_torch import modeling as tmodeling
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.modeling import (
    InfiniteModel, OrthogonalCollocation, integral, deriv, sin,
    constant_over_collocation, All, uniform, expect)
from infiniteexamodels_jl_torch.solvers import IpmSolver

TOL = 1e-6


def port_model(**kw):
    return InfiniteModel(ExaTranscriptionBackend(IpmSolver, device="cpu"),
                         **kw)


def jax_objective(build):
    """The objective the JAX package reaches on ``build(M, model)``."""
    m = jmodeling.InfiniteModel(JBackend(JIpmSolver))
    build(jmodeling, m)
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    return m.objective_value()


def test_five_by_five_oracle():
    """reference test/ipopt.jl:4-18 (oracle -1.2784599900757165e+01)."""
    m = port_model()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    x = m.infinite_parameter("x", domain=(-1, 1), num_supports=5)
    y = m.variable("y", deps=(t, x), lb=0)
    z = m.variable("z", start=10)
    m.minimize(integral(integral(y**2, t) + 2 * z, x))
    m.constraint(deriv(y, t) == sin(y) + z + 1.2)
    m.constraint(y + z <= 42 + t)
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(-12.784599900757165, abs=TOL)
    # tightened options oracle (test/ipopt.jl:41)
    m.set_attribute("tol", 1e-6)
    m.set_attribute("mu_init", 1e-2)
    m.set_attribute("max_iter", 50)
    m.optimize()
    assert m.objective_value() == pytest.approx(-12.784599867885884, abs=TOL)


def _problem1(M, m):
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    x = m.infinite_parameter("x", domain=(-1, 1), num_supports=5)
    y = m.variable("y", deps=(t, x), lb=0)
    z = m.variable("z", start=10)
    m.minimize(M.integral(M.integral(y**2, t), x) + 2 * y(0, 1))
    m.constraint(M.deriv(y, t) == M.sin(y) + z + 1.2)
    m.constraint(y + z <= 42 + t,
                 restriction=M.DomainRestriction(lambda s: 0 <= s <= 0.5, t))
    m.constraint(M.deriv(y(0, x), x) == 5)
    return t, x, y, z


def test_problem1_structure_and_self_consistency():
    """reference test/solve.jl Test Problem 1 (no hard-coded oracle: the
    JAX package's objective on the same model instead)."""
    m = port_model()
    t, x, y, z = _problem1(tmodeling, m)
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    yv = np.asarray(m.value(y))
    xg = np.linspace(-1, 1, 5)
    slopes = np.diff(yv[0, :]) / np.diff(xg)
    np.testing.assert_allclose(slopes, 5.0, atol=1e-5)
    dyv = np.asarray(m.value(deriv(y, t)))
    zv = m.value(z)
    np.testing.assert_allclose(dyv, np.sin(yv) + zv + 1.2, atol=1e-5)
    assert m.objective_value() == pytest.approx(jax_objective(_problem1),
                                                abs=TOL)


def test_orthogonal_collocation_accuracy():
    """OC integrates dy/dt = -y to 1e-8 (the Lobatto stencils)."""
    m = port_model()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=11,
                             derivative_method=OrthogonalCollocation(4))
    y = m.variable("y", deps=(t,), lb=0)
    u = m.variable("u", deps=(t,))
    m.constraint(deriv(y, t) == -y)
    m.constraint(y(0) == 1)
    constant_over_collocation(u, t)
    m.constraint(u == 0)
    m.minimize(integral((y - 0.5)**2, t))
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    yv = np.asarray(m.value(y))
    tg = np.asarray(m.supports(y))
    np.testing.assert_allclose(yv, np.exp(-tg), atol=1e-8)


def test_constant_over_collocation_ties_nodes():
    m = port_model()
    t = m.infinite_parameter("t", domain=(0, 2), num_supports=5,
                             derivative_method=OrthogonalCollocation(3))
    y = m.variable("y", deps=(t,))
    u = m.variable("u", deps=(t,))
    m.constraint(deriv(y, t) == u)
    m.constraint(y(0) == 0)
    constant_over_collocation(u, t)
    m.minimize(integral((y - t * 1.0)**2, t) + integral(0.0 * u**2, t))
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    uv_all = np.asarray(m.value(u, label=All))
    # layout (OC(3), 5 public): [p0, i, p1, i, p2, i, p3, i, p4]
    for e in range(4):
        base = e * 2
        assert uv_all[base + 1] == pytest.approx(uv_all[base + 2], abs=1e-9)


def test_parameter_updates_oracle():
    """reference test/solve.jl:134-162 (306.4999755050365 ->
    276.26497794903645); a new finite parameter invalidates the backend."""
    m = port_model()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    p1 = m.finite_parameter("p1", 100.0)
    p2 = m.finite_parameter("p2", 1.0)
    x = [m.variable(f"x{i}", deps=(t,)) for i in range(2)]
    m.minimize(p1 * integral((x[1] - x[0]**2)**2, t)
               + integral((p2 - x[0])**2, t))
    for i, ub in enumerate([0.5, 3.0]):
        m.constraint(x[i] <= ub)
    m.constraint(x[0] * x[1] >= 1.0)
    m.constraint(x[0] + x[1]**2 >= 0.0)
    m.set_silent()
    m.optimize()
    assert m.objective_value() == pytest.approx(306.4999755050365, abs=TOL)
    assert m.value(p1) == 100.0
    assert m.value(p2) == 1.0
    m.set_parameter_value(p1, 90.0)
    m.set_parameter_value(p2, 1.3)
    assert m.transformation_backend_ready()
    m.optimize()
    assert m.objective_value() == pytest.approx(276.26497794903645, abs=TOL)
    assert m.value(p1) == 90.0
    assert m.value(p2) == 1.3
    p3 = m.finite_parameter("p3", 43.0)
    m.constraint(x[0]**2 + x[1]**2 <= p3)
    m.set_parameter_value(p3, 50.0)
    assert not m.transformation_backend_ready()


def test_parameter_function_updates_oracle():
    """reference test/solve.jl:166-209 (0.48292223509341475 ->
    0.8155916466182952)."""
    def oldpf2(tv, sv):
        return np.sin(tv) * sv + 0.2

    def newpf2(tv, sv):
        return np.sin(tv) * sv + 0.8

    m = port_model()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    s = m.infinite_parameter("s", domain=(2, 3), num_supports=3)
    v = m.variable("v", deps=(t,), lb=0, ub=100)
    z = m.variable("z", deps=(t, s), lb=0, ub=100)
    pf1 = m.parameter_function(np.sin, (t,), name="pf1")
    pf2 = m.parameter_function(oldpf2, (t, s), name="pf2")
    m.constraint(v + pf1 <= 100)
    m.constraint(v * 2 + pf1 * pf2 <= 100)
    m.constraint(v >= 0.5 * pf2)
    m.constraint(z(t, 2.5) + pf2 * pf1 <= 40)
    m.minimize(integral(v * pf1, t) + integral(integral(0.5 * z * pf2, t), s))
    m.set_silent()
    m.optimize()
    assert m.objective_value() == pytest.approx(0.48292223509341475, abs=TOL)
    tg = np.array([0.0, 0.5, 1.0])
    sg = np.array([2.0, 2.5, 3.0])
    np.testing.assert_allclose(m.value(pf1), np.sin(tg))
    np.testing.assert_allclose(np.asarray(m.value(pf2)),
                               np.sin(tg)[:, None] * sg[None, :] + 0.2)
    m.set_parameter_value(pf1, np.cos)
    m.set_parameter_value(pf2, newpf2)
    assert m.transformation_backend_ready()
    np.testing.assert_allclose(m.value(pf1), np.cos(tg))
    np.testing.assert_allclose(np.asarray(m.value(pf2)),
                               np.sin(tg)[:, None] * sg[None, :] + 0.8)
    m.optimize()
    assert m.objective_value() == pytest.approx(0.8155916466182952, abs=TOL)


def test_semi_infinite_pf_in_measure():
    """reference test/solve.jl:119 c5: v * integral(pf2, s) <= 100."""
    m = port_model()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    s = m.infinite_parameter("s", domain=(2, 3), num_supports=5)
    v = m.variable("v", deps=(t,), lb=0, ub=100)
    pf2 = m.parameter_function(lambda tv, sv: np.sin(tv) * sv + 0.2, (t, s))
    m.constraint(v * integral(pf2, s) <= 100)
    m.minimize(integral((v - 3.0)**2, t))
    m.set_silent()
    with pytest.warns(UserWarning, match="Constrained measures"):
        res = m.optimize()
    assert res.status == "first_order"
    np.testing.assert_allclose(np.asarray(m.value(v)), 3.0, atol=1e-6)


def test_start_value_updates_keep_ready():
    """reference test/solve.jl:212-240."""
    m = port_model()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    x = m.variable("x", deps=(t,))
    z = m.variable("z", start=3)
    m.constraint(x + z == 1)
    m.build_transformation_backend()
    b = m.backend
    assert m.transformation_backend_ready()
    m.set_start_value(z, 10)
    assert m.transformation_backend_ready()
    zv = b.data.lookup(z)
    assert b.core.x0[zv.i] == 10
    m.set_start_value(x, 20)
    assert m.transformation_backend_ready()
    xv = b.data.lookup(x)
    assert np.all(b.core.x0[xv.offset:xv.offset + xv.length] == 20)
    m.set_start_value(x, lambda tv: 42)
    assert m.transformation_backend_ready()
    assert np.all(b.core.x0[xv.offset:xv.offset + xv.length] == 42)
    w = m.variable("w")
    assert not m.transformation_backend_ready()
    m.set_start_value(w, 5)
    assert not m.transformation_backend_ready()


def test_expectation_measure():
    """E[(v - xi)^2] over MC samples: the optimum is v = mean(xi)."""
    m = port_model(seed=7)
    xi = m.infinite_parameter("xi", dist=uniform(0.0, 1.0), num_supports=200)
    v = m.variable("v")
    m.minimize(expect((v - xi)**2, xi))
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    samples = np.asarray(m.value(xi, label=All))
    assert m.value(v) == pytest.approx(float(samples.mean()), abs=1e-7)


def test_maximize_objective_sense():
    m = port_model(seed=1)
    xi = m.infinite_parameter("xi", dist=uniform(0.0, 2.0), num_supports=50)
    y = m.variable("y", deps=(xi,), lb=0, ub=1)
    m.maximize(expect(1 - y**2, xi))
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(np.asarray(m.value(y)), 0.0, atol=1e-3)
