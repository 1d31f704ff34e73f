"""The SEIR pandemic family through the port on the CPU: the elastic cap at
(51,4) against the JAX package's oracle (tests/test_models.py), the rollout
warm start's feasibility, and the stall-triggered least-squares dual recalc
firing at the same iterations as in the JAX package."""
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
from infiniteexamodels_jl_torch.transcribe import transcribe as ttranscribe
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


def test_pandemic_elastic_cap():
    m = tmodels.pandemic(num_supports=51, num_scenarios=4, elastic_rho=500.0)
    m.set_transformation_backend(ExaTranscriptionBackend(
        IpmSolver, device="cpu", linear_solver="auto", tol=1e-6))
    m.set_silent()
    m.set_attribute("max_iter", 400)
    res = m.optimize()
    assert res.status == "first_order"
    assert res.iter < 400
    v = next(vv for vv in m.infinite_vars if vv.name == "v_imax")
    assert np.max(np.asarray(m.value(v))) <= 1e-6     # cap not relaxed
    i_var = next(vv for vv in m.infinite_vars if vv.name == "i")
    assert np.all(np.asarray(m.value(i_var)) <= 0.02 + 1e-5)
    assert m.objective_value() == pytest.approx(ORACLES["pandemic51x4"],
                                                abs=5e-3)


def test_pandemic_rollout_start_feasible():
    """``u_start``: the transcribed start satisfies every equality row
    (dynamics, derivative definitions, initial conditions) to Newton
    tolerance; the callable form equals the array form."""
    m = tmodels.pandemic(num_supports=40, num_scenarios=4, u_start=0.3)
    model, _ = ttranscribe(m, device="cpu")
    c = model.cons(model.x0, model.theta).numpy()
    lc, uc = model.lcon.numpy(), model.ucon.numpy()
    eq = lc == uc
    viol = np.maximum(lc - c, c - uc).clip(min=0.0)
    assert viol[eq].max() < 1e-9
    m2 = tmodels.pandemic(num_supports=40, num_scenarios=4,
                          u_start=lambda t: 0.3)
    model2, _ = ttranscribe(m2, device="cpu")
    assert np.array_equal(model2.x0.numpy(), model.x0.numpy())


class _JaxRecorder(JIpmSolver):
    """Notes the iteration of every least-squares dual recalc."""
    fired = []

    def _ensure_lsq_jit(self):
        lsq = super()._ensure_lsq_jit()

        def recorded(st, consts):
            _JaxRecorder.fired.append(int(st.iter))
            return lsq(st, consts)
        return recorded


class _PortRecorder(IpmSolver):
    fired = []

    def _lsq_duals(self, st, consts):
        _PortRecorder.fired.append(int(st.iter))
        return super()._lsq_duals(st, consts)


def test_recalc_y_stall_fires_where_the_jax_package_does():
    """The reference evaluates the stall trigger where its non-verbose loop
    returns to the host (every 32 iterations); the port steps one iteration
    at a time and must fire at the same iterations.  tol 1e-2 makes the
    trigger's primal gate (pr <= 1e2*tol) open at iteration 32, while the
    two trajectories still agree (E0 to ~1e-7 there, measured); max_iter 50
    ends the run at the limit, which is a host return too."""
    opts = dict(linear_solver="auto", print_level=0, tol=1e-2, max_iter=50,
                recalc_y_stall=True)
    results = {}
    for name, M, backend, solver, kw in (
            ("jax", jmodels, JBackend, _JaxRecorder, {}),
            ("port", tmodels, ExaTranscriptionBackend, _PortRecorder,
             dict(device="cpu"))):
        solver.fired = []
        m = M.pandemic(num_supports=25, num_scenarios=4)
        b = backend(solver, **kw, **opts)
        m.set_transformation_backend(b)
        b.build(m)
        results[name] = (b.optimize(m), list(solver.fired))
    (jres, jfired), (tres, tfired) = results["jax"], results["port"]
    assert jfired == [32, 50]
    assert tfired == jfired
    assert (tres.status, tres.iter) == (jres.status, jres.iter)
    assert tres.objective == pytest.approx(jres.objective, rel=1e-7)
