"""tests/test_queries.py through the port on the CPU: constraint and domain
duals, supports, label filtering with collocation, and the objective and
solve time (the reference's map_dual/variable_supports surface); the duals
are held to the JAX package's on the same model as well."""
import numpy as np
import pytest

from infiniteexamodels_jl_tpu import modeling as jmodeling
from infiniteexamodels_jl_tpu.backend import (
    ExaTranscriptionBackend as JBackend)
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver
from infiniteexamodels_jl_torch import modeling as tmodeling
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.modeling import (
    InfiniteModel, OrthogonalCollocation, integral, deriv, All,
    InternalLabel)
from infiniteexamodels_jl_torch.solvers import IpmSolver


def build_and_solve(M=tmodeling, backend=None):
    m = M.InfiniteModel(backend or ExaTranscriptionBackend(IpmSolver,
                                                           device="cpu"))
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    y = m.variable("y", deps=(t,), lb=0)
    z = m.variable("z")
    c1 = m.constraint(M.deriv(y, t) == -y + z)
    c2 = m.constraint(y(0) == 1.0)
    c3 = m.constraint(z <= 0.25)
    m.minimize(M.integral((y - 0.5)**2, t) + z**2)
    m.set_silent()
    m.optimize()
    return m, t, y, z, c1, c2, c3


@pytest.fixture(scope="module")
def solved():
    return build_and_solve()


@pytest.fixture(scope="module")
def jax_solved():
    return build_and_solve(jmodeling, JBackend(JIpmSolver))


def test_constraint_duals(solved, jax_solved):
    m, t, y, z, c1, c2, c3 = solved
    d1 = np.asarray(m.dual(c1))
    assert d1.shape == (5,)
    d2 = m.dual(c2)
    assert np.isscalar(d2) or np.asarray(d2).shape == ()
    assert m.backend.results.dual_feas < 1e-6
    jm, *_, jc1, jc2, jc3 = jax_solved
    for c, jc in ((c1, jc1), (c2, jc2), (c3, jc3)):
        np.testing.assert_allclose(np.asarray(m.dual(c)),
                                   np.asarray(jm.dual(jc)), rtol=1e-6,
                                   atol=1e-8)


def test_supports_queries(solved):
    m, t, y, z, c1, c2, c3 = solved
    st = np.asarray(m.supports(y))
    np.testing.assert_allclose(st, np.linspace(0, 1, 5))
    sc = np.asarray(m.supports(c1))
    np.testing.assert_allclose(sc, st)
    assert m.supports(z) == ()
    np.testing.assert_allclose(np.asarray(m.value(t, label=All)), st)


def test_label_filtering_with_collocation():
    m = InfiniteModel(ExaTranscriptionBackend(IpmSolver, device="cpu"))
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=4,
                             derivative_method=OrthogonalCollocation(3))
    y = m.variable("y", deps=(t,), lb=0)
    m.constraint(deriv(y, t) == -y)
    m.constraint(y(0) == 1)
    m.minimize(integral(y, t))
    m.set_silent()
    m.optimize()
    pub = np.asarray(m.value(y))
    allv = np.asarray(m.value(y, label=All))
    internal = np.asarray(m.value(y, label=InternalLabel))
    assert pub.shape == (4,)
    assert allv.shape == (7,)
    assert internal.shape == (3,)
    np.testing.assert_allclose(
        np.sort(np.concatenate([pub, internal])), np.sort(allv))


def test_domain_duals(solved, jax_solved):
    m, t, y, z, c1, c2, c3 = solved
    mL, mU = m.backend.domain_duals(y)
    assert np.asarray(mL).shape == (5,)
    # y > 0 at the solution: the lower-bound duals vanish
    assert np.max(np.abs(np.asarray(mL))) < 1e-5
    jm, jt, jy = jax_solved[:3]
    jL, jU = jm.backend.domain_duals(jy)
    np.testing.assert_allclose(np.asarray(mL), np.asarray(jL), atol=1e-8)
    np.testing.assert_allclose(np.asarray(mU), np.asarray(jU), atol=1e-8)


def test_objective_and_solve_time(solved):
    m = solved[0]
    assert np.isfinite(m.objective_value())
    assert m.solve_time() > 0
    assert m.backend.result_count() == 1
