"""tests/test_untested_surface.py through the port on the CPU: the Forward
and Central finite-difference schemes, the ``MadIpmSolver`` alias, the
"ma27" alias of the host LDL, the timers' split of the first step from the
rest, and a resume from a checkpoint taken mid-regularization (slow, as in
the JAX package).  The JAX file's
``test_checkpoint_without_log_fields_loads`` is ported as
tests/test_torch_checkpoint.py::test_checkpoint_without_log_rr_loads."""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.models import hovercraft, kinetic_control
from infiniteexamodels_jl_torch.modeling import (
    InfiniteModel, FiniteDifference, Forward, Central, integral, deriv)
from infiniteexamodels_jl_torch.solvers import (IpmSolver, MadIpmSolver,
                                                DenseKKT)
from infiniteexamodels_jl_torch.solvers.block_tridiag import BlockTridiagKKT
from infiniteexamodels_jl_torch.solvers.cpp_ldl import CppLdlKKT
from infiniteexamodels_jl_torch.transcribe import transcribe

HOVERCRAFT41 = 0.04245763849025232      # tests/test_models.py ORACLES


def _exp_decay_model(scheme):
    """dy/dt = -y, y(0)=1 on [0,1]: y = exp(-t); the objective integrates
    y^2 -> (1-exp(-2))/2."""
    m = InfiniteModel(ExaTranscriptionBackend(IpmSolver, device="cpu"))
    t = m.infinite_parameter(
        "t", domain=(0, 1), num_supports=201,
        derivative_method=FiniteDifference(scheme))
    y = m.variable("y", deps=(t,), start=1.0)
    m.constraint(deriv(y, t) == -y)
    m.constraint(y(0) == 1)
    m.minimize(integral(y**2, t))
    m.set_silent()
    return m, y, t


def test_forward_fd_solves_exp_decay():
    m, y, t = _exp_decay_model(Forward)
    res = m.optimize()
    assert res.status == "first_order"
    tg = np.asarray(m.supports(y))
    yv = np.asarray(m.value(y))
    np.testing.assert_allclose(yv, np.exp(-tg), atol=1e-2)  # O(h)
    exact = (1 - np.exp(-2)) / 2
    assert m.objective_value() == pytest.approx(exact, abs=5e-2)


def test_central_fd_stencil_relation_holds():
    """At the solution the defining equations enforce
    d[i] == (y[i+1]-y[i-1])/(t[i+1]-t[i-1]) at every interior support, and
    the algebraic constraint d == -y everywhere."""
    m, y, t = _exp_decay_model(Central)
    res = m.optimize()
    assert res.status == "first_order"
    tg = np.asarray(m.supports(y))
    yv = np.asarray(m.value(y))
    dv = np.asarray(m.value(deriv(y, t)))
    np.testing.assert_allclose(dv[1:-1] * (tg[2:] - tg[:-2]),
                               yv[2:] - yv[:-2], atol=1e-7)
    np.testing.assert_allclose(dv, -yv, atol=1e-7)


def test_mad_ipm_solver_alias():
    """``MadIpmSolver`` defaults to the structured KKT and reproduces the
    ``IpmSolver`` oracle."""
    m = hovercraft(num_supports=41)
    m.set_transformation_backend(ExaTranscriptionBackend(MadIpmSolver,
                                                         device="cpu"))
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(HOVERCRAFT41, abs=1e-6)
    assert isinstance(m.backend.solver.kkt, (BlockTridiagKKT, DenseKKT))


def test_ma27_linear_solver_alias():
    """linear_solver="ma27" routes to the host LDL (the role MA27 plays
    under Ipopt)."""
    m = hovercraft(num_supports=31)
    m.set_transformation_backend(ExaTranscriptionBackend(
        IpmSolver, device="cpu", linear_solver="ma27"))
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    assert isinstance(m.backend.solver.kkt, CppLdlKKT)


def test_timers_split_compile_from_warm_steps():
    """The first step's time is reported apart from the steps' total."""
    model, _ = transcribe(hovercraft(num_supports=31), device="cpu")
    res = IpmSolver(model, print_level=0, linear_solver="auto").solve()
    t = res.timers
    assert np.isfinite(t["first_chunk"]) and t["first_chunk"] > 0
    assert t["step_total"] >= t["first_chunk"]


@pytest.mark.slow
def test_checkpoint_resume_mid_regularization(tmp_path):
    """A checkpoint taken while the solver regularizes resumes to the same
    optimum."""
    model, _ = transcribe(kinetic_control(num_supports=20), device="cpu")
    ref = IpmSolver(model, print_level=0, linear_solver="auto",
                    tol=1e-8).solve()
    assert ref.status == "first_order"
    s = IpmSolver(model, print_level=0, linear_solver="auto", tol=1e-8)
    ckpt = str(tmp_path / "mid.npz")
    s.solve(checkpoint_path=ckpt, checkpoint_every=2, max_iter=9)
    st = s.load_checkpoint(ckpt)
    assert int(st.iter) > 0 and st.iter.dtype == torch.int32
    s2 = IpmSolver(model, print_level=0, linear_solver="auto", tol=1e-8)
    res = s2.solve(resume_from=ckpt, max_iter=3000)
    assert res.status == "first_order"
    assert res.objective == pytest.approx(ref.objective, abs=1e-7)
