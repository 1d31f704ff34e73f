"""Solves of the model families through the port on the CPU, held to the
JAX package's oracles with the tolerances its own tests use
(tests/test_models.py ORACLES, imported): hovercraft-41 through its
waypoints, the scenario and collocation families, and opf-64 through the
scenario KKT at the objective the JAX package reaches on the same model.
The JAX file's three slow pandemic solves are
tests/test_torch_pandemic_slow.py."""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.backend import (
    ExaTranscriptionBackend as JBackend)
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.solvers.block_tridiag import BlockTridiagKKT
from test_models import ORACLES


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's solves run on one intra-op thread: their tensors are
    small, and test workers that each keep a pool of spinning OpenMP threads
    on the same cores slow one another several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def attach(m, **opts):
    m.set_transformation_backend(ExaTranscriptionBackend(
        IpmSolver, device="cpu", linear_solver="auto", **opts))
    m.set_silent()
    return m


def test_hovercraft_hits_waypoints():
    m = attach(tmodels.hovercraft(num_supports=41))
    res = m.optimize()
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(ORACLES["hovercraft41"],
                                                abs=1e-6)
    xvals = [np.asarray(m.value(v))
             for v in (m.infinite_vars[0], m.infinite_vars[1])]
    tg = np.asarray(m.supports(m.infinite_vars[0]))
    xw = np.array([[1, 4, 6, 1], [1, 3, 0, 1]], dtype=float)
    for j, tw in enumerate([0.0, 25.0, 50.0, 60.0]):
        k = int(np.argmin(np.abs(tg - tw)))
        assert xvals[0][k] == pytest.approx(xw[0, j], abs=1e-6)
        assert xvals[1][k] == pytest.approx(xw[1, j], abs=1e-6)


@pytest.fixture(scope="module")
def farmer300():
    m = attach(tmodels.farmer(num_scenarios=300))
    return m, m.optimize()


def test_farmer(farmer300):
    m, res = farmer300
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(ORACLES["farmer300"],
                                                rel=1e-9)
    kkt = m.backend.solver.kkt
    assert type(kkt) is BlockTridiagKKT
    assert (kkt.mode, kkt.nb, kkt.bs, kkt.mB) == ("block_diag", 300, 8, 3)
    xs = [m.value(v) for v in m.finite_vars]
    assert sum(xs) <= 500.0 + 1e-6
    assert all(x >= -1e-8 for x in xs)


def test_farmer_scipy_anchor(farmer300):
    """The farmer LP rebuilt from its published formulation as plain scipy
    arrays and solved by HiGHS; only the sampled yields are shared."""
    from scipy.optimize import linprog

    m, res = farmer300
    n_s = 300
    xi = np.asarray(m.groups[0].supports())
    assert xi.shape == (n_s, 3)
    alpha = [150.0, 230.0, 260.0]
    beta = [238.0, 210.0, 0.0]
    lam = [170.0, 150.0, 36.0]
    d = [200.0, 240.0, 0.0]
    nv = 3 + 6 * n_s
    c = np.zeros(nv)
    c[:3] = alpha
    A_ub = [np.r_[np.ones(3), np.zeros(6 * n_s)]]
    b_ub = [500.0]
    bounds = [(0, 500.0)] * 3
    for s in range(n_s):
        o = 3 + 6 * s
        c[o:o + 3] = np.array(beta) / n_s
        c[o + 3:o + 6] = -np.array(lam) / n_s
        for cc in range(3):
            row = np.zeros(nv)
            row[cc] = -xi[s, cc]          # -(xi*x + y - w) <= -d
            row[o + cc] = -1.0
            row[o + 3 + cc] = 1.0
            A_ub.append(row)
            b_ub.append(-d[cc])
        bounds += [(0, None), (0, None), (0, 0.0),
                   (0, None), (0, None), (0, 6000.0)]
    lp = linprog(c, A_ub=np.array(A_ub), b_ub=np.array(b_ub),
                 bounds=bounds, method="highs")
    assert lp.status == 0
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(lp.fun, rel=1e-8)


def test_design_3node():
    m = attach(tmodels.design_3node(num_scenarios=200))
    res = m.optimize()
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(ORACLES["design3node200"],
                                                abs=1e-6)


def test_kinetics_small():
    m = attach(tmodels.kinetic_control(num_supports=30))
    res = m.optimize()
    assert res.status in ("first_order", "acceptable")
    assert m.objective_value() == pytest.approx(ORACLES["kinetics30"],
                                                abs=1e-6)


@pytest.mark.slow
def test_opf_stochastic():
    """opf-10 (slow, as in the JAX package: small enough for the dense KKT,
    where both packages crawl -- the JAX package 651 iterations, the port
    1104 on the CPU)."""
    m = attach(tmodels.opf(num_supports=10))
    res = m.optimize()
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(ORACLES["opf10"], rel=1e-6)


def test_opf_static_pglib_anchor():
    """pglib-opf case3_lmbd as a single-period AC-OPF: the published
    base-case objective 5812.64 $/h (quoted to two decimals)."""
    m = attach(tmodels.opf_static())
    res = m.optimize()
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(5812.64, abs=0.01)


@pytest.fixture(scope="module")
def opf64_jax():
    """opf-64 solved by the JAX package on the CPU, as the port solves it."""
    m = jmodels.opf(num_supports=64)
    m.set_transformation_backend(JBackend(JIpmSolver, linear_solver="auto",
                                          tol=1e-6))
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    return m.objective_value()


def test_opf64_scenario_kkt_at_the_jax_objective(opf64_jax):
    m = attach(tmodels.opf(num_supports=64), tol=1e-6)
    res = m.optimize()
    kkt = m.backend.solver.kkt
    assert type(kkt) is BlockTridiagKKT
    # one block of 24 per scenario plus the first-stage block; the border
    # is pg0/qg0, which every scenario's ramping rows touch
    assert (kkt.mode, kkt.nb, kkt.bs, kkt.mB) == ("block_diag", 65, 24, 6)
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(opf64_jax, rel=1e-9)
