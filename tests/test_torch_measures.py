"""tests/test_measures.py through the port on the CPU: trapezoid,
expectation and support-sum coefficients, weight functions, nested
measures, Gauss-Legendre quadrature and the bound/start sugar, each
evaluated at the start point against its closed form, and against the JAX
package's evaluation of the same model."""
import numpy as np
import pytest

from infiniteexamodels_jl_tpu import modeling as jmodeling
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch import modeling as tmodeling
from infiniteexamodels_jl_torch.transcribe import transcribe


def eval_objective(m):
    simd, data = transcribe(m, device="cpu")
    return float(simd.obj(simd.x0, simd.theta))


def both(build, **kw):
    """The port's and the JAX package's objective at the start point of
    ``build(M, model)``, and the port's model and what ``build`` returned."""
    m = tmodeling.InfiniteModel(**kw)
    out = build(tmodeling, m)
    jm = jmodeling.InfiniteModel(**kw)
    build(jmodeling, jm)
    simd, _ = jtranscribe(jm)
    return eval_objective(m), float(simd.obj(simd.x0, simd.theta)), m, out


def test_trapezoid_weights():
    def build(M, m):
        t = m.infinite_parameter("t", domain=(0, 2), num_supports=5)
        y = m.variable("y", deps=(t,), start=lambda tv: tv**2)
        m.minimize(M.integral(y, t))
    got, ref, _, _ = both(build)
    tg = np.linspace(0, 2, 5)
    assert got == pytest.approx(np.trapezoid(tg**2, tg))
    assert got == pytest.approx(ref, rel=1e-14)


def test_integral_weight_function():
    def build(M, m):
        t = m.infinite_parameter("t", domain=(0, 1), num_supports=9)
        y = m.variable("y", deps=(t,), start=1.0)
        m.minimize(M.integral(y, t, weight_fn=lambda tv: tv))
    got, ref, _, _ = both(build)
    tg = np.linspace(0, 1, 9)
    assert got == pytest.approx(np.trapezoid(tg, tg))
    assert got == pytest.approx(ref, rel=1e-14)


def test_expectation_weights():
    def build(M, m):
        xi = m.infinite_parameter("xi", dist=M.uniform(0, 1),
                                  num_supports=50)
        y = m.variable("y", deps=(xi,), start=lambda v: v)
        m.minimize(M.expect(y, xi))
        return xi
    got, ref, _, xi = both(build, seed=3)
    samples = xi.group.supports()
    assert got == pytest.approx(float(samples.mean()))
    assert got == pytest.approx(ref, rel=1e-14)


def test_support_sum():
    def build(M, m):
        t = m.infinite_parameter("t", domain=(0, 1), num_supports=4)
        y = m.variable("y", deps=(t,), start=2.0)
        m.minimize(M.support_sum(y, t))
    got, ref, _, _ = both(build)
    assert got == pytest.approx(8.0)
    assert got == ref


def test_nested_measures_value():
    def build(M, m):
        t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
        s = m.infinite_parameter("s", domain=(0, 2), num_supports=7)
        y = m.variable("y", deps=(t, s), start=lambda tv, sv: tv * sv)
        m.minimize(M.integral(M.integral(y, t), s))
    got, ref, _, _ = both(build)
    tg = np.linspace(0, 1, 5)
    sg = np.linspace(0, 2, 7)
    inner = np.trapezoid(tg[:, None] * sg[None, :], tg, axis=0)
    assert got == pytest.approx(float(np.trapezoid(inner, sg)))
    assert got == pytest.approx(ref, rel=1e-14)


def test_bound_mutation_sugar():
    m = tmodeling.InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    y = m.variable("y", deps=(t,), lb=0.0, ub=5.0)
    y.set_upper_bound(3.0)
    y.delete_lower_bound()
    y.set_start_value(1.5)
    simd, data = transcribe(m, device="cpu")
    var = data.lookup(y)
    core = simd.core
    assert np.all(core.uvar[var.offset:var.offset + 3] == 3.0)
    assert np.all(np.isinf(core.lvar[var.offset:var.offset + 3]))
    assert np.all(core.x0[var.offset:var.offset + 3] == 1.5)


def test_variables_helper():
    m = tmodeling.InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    xs = m.variables(3, name="x", deps=(t,), lb=[0.0, 1.0, 2.0])
    simd, data = transcribe(m, device="cpu")
    for i, v in enumerate(xs):
        var = data.lookup(v)
        assert np.all(simd.core.lvar[var.offset:var.offset + 3] == float(i))


def test_gauss_legendre_integral_exactness():
    """4-point Gauss-Legendre integrates t^6 exactly (1/7); its nodes are
    internal supports; the trapezoid rule on the same 5 supports is off by
    more than 1e-3."""
    def build(M, m):
        t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
        y = m.variable("y", deps=(t,), start=lambda tv: tv**6)
        m.minimize(M.integral(y, t, method="gauss_legendre", num_nodes=4))
        return t
    got, ref, _, t = both(build)
    assert got == pytest.approx(1.0 / 7.0, abs=1e-12)
    assert got == pytest.approx(ref, rel=1e-14)
    g = t.group
    assert g.num_supports() == 5 + 4
    assert g.public_mask().sum() == 5

    m2 = tmodeling.InfiniteModel()
    t2 = m2.infinite_parameter("t", domain=(0, 1), num_supports=5)
    y2 = m2.variable("y", deps=(t2,), start=lambda tv: tv**6)
    m2.minimize(tmodeling.integral(y2, t2))
    assert abs(eval_objective(m2) - 1.0 / 7.0) > 1e-3


def test_gauss_legendre_weight_fn():
    def build(M, m):
        t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
        y = m.variable("y", deps=(t,), start=1.0)
        m.minimize(M.integral(y, t, weight_fn=lambda tv: 3 * tv**2,
                              method="gauss_legendre", num_nodes=6))
    got, ref, _, _ = both(build)
    assert got == pytest.approx(1.0, abs=1e-12)
    assert got == pytest.approx(ref, rel=1e-14)
