"""tests/test_backend_options.py through the port on the CPU: the options /
prev_options state machine of the reference (test/ipopt.jl,
test/madnlp.jl), status queries, warm starts, a rebuild after a change of
structure and checkpoint/resume, held to the JAX test's oracles."""
import numpy as np
import pytest

from infiniteexamodels_jl_torch.modeling import (
    InfiniteModel, integral, deriv, sin)
from infiniteexamodels_jl_torch.backend import (
    ExaTranscriptionBackend, NoOptimizerError)
from infiniteexamodels_jl_torch.solvers import IpmSolver, TerminationStatus

FIVE_BY_FIVE = -12.784599900757165          # test/ipopt.jl:18
FIVE_BY_FIVE_TIGHT = -12.784599867885884    # test/ipopt.jl:41


def five_by_five(solver=IpmSolver):
    m = InfiniteModel(ExaTranscriptionBackend(solver, device="cpu"))
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    x = m.infinite_parameter("x", domain=(-1, 1), num_supports=5)
    y = m.variable("y", deps=(t, x), lb=0)
    z = m.variable("z", start=10)
    m.minimize(integral(integral(y**2, t) + 2 * z, x))
    m.constraint(deriv(y, t) == sin(y) + z + 1.2)
    m.constraint(y + z <= 42 + t)
    return m, y, z


def test_option_updates_1(capsys):
    """'Ipopt option updates 1': silent + time limit, then unsilence + new
    options; the exact prev_options states."""
    m, y, z = five_by_five()
    b = m.backend
    m.set_silent()
    m.set_time_limit_sec(120.0)
    assert b.silent is True
    assert b.time_limit == 120.0
    m.optimize()
    assert capsys.readouterr().out == ""
    assert m.objective_value() == pytest.approx(FIVE_BY_FIVE, abs=1e-6)
    assert set(b.options) == {"solver"}
    assert b.prev_options == {"print_level": 0, "max_wall_time": 120.0}
    assert b.results is not None

    m.unset_silent()
    m.set_time_limit_sec(200.0)
    m.set_attribute("max_iter", 50)
    m.set_attribute("mu_init", 1e-2)
    m.set_attribute("tol", 1e-6)
    assert b.silent is False
    assert b.results is not None
    m.optimize()
    out = capsys.readouterr().out
    assert "iter" in out
    assert m.objective_value() == pytest.approx(FIVE_BY_FIVE_TIGHT, abs=1e-6)
    assert b.options == {"solver": IpmSolver, "max_iter": 50,
                         "mu_init": 1e-2, "tol": 1e-6}
    assert b.prev_options == {"max_iter": 50, "mu_init": 1e-2, "tol": 1e-6,
                              "print_level": 5, "max_wall_time": 200.0}


def test_option_updates_2(capsys):
    """'Ipopt option updates 2': start loud, then silence + unset time
    limit restores the defaults."""
    m, y, z = five_by_five()
    b = m.backend
    m.set_time_limit_sec(60.0)
    m.optimize()
    assert capsys.readouterr().out != ""
    assert b.prev_options == {"max_wall_time": 60.0}
    m.set_silent()
    m.set_time_limit_sec(None)
    m.optimize()
    assert capsys.readouterr().out == ""
    assert b.prev_options == {"print_level": 0, "max_wall_time": 1.0e20}


def test_set_optimizer_resets_options():
    m, y, z = five_by_five()
    b = m.backend
    m.set_attribute("max_iter", 10)
    m.set_optimizer(IpmSolver, tol=1e-7)
    assert b.options == {"solver": IpmSolver, "tol": 1e-7}
    assert b.solver is None


def test_no_optimizer_error():
    m, y, z = five_by_five()
    m.backend.options.pop("solver")
    with pytest.raises(NoOptimizerError):
        m.optimize()


def test_status_queries():
    m, y, z = five_by_five()
    b = m.backend
    assert b.result_count() == 0
    assert b.raw_status() == "optimize not called"
    assert b.termination_status() == TerminationStatus.OPTIMIZE_NOT_CALLED
    m.set_silent()
    m.optimize()
    assert b.result_count() == 1
    assert b.raw_status() == "first_order"
    assert b.termination_status() == TerminationStatus.LOCALLY_SOLVED
    assert np.isfinite(b.solve_time_sec())


def test_warmstart_reduces_iterations():
    """ipopt.jl:180-195: a warm start cuts the iterations."""
    m, y, z = five_by_five()
    m.set_silent()
    res_cold = m.optimize()
    m.warmstart_backend_start_values()
    b = m.backend
    np.testing.assert_array_equal(np.asarray(b.core.x0),
                                  np.asarray(res_cold.solution))
    m.set_attribute("mu_init", 1e-8)
    res_warm = m.optimize()
    assert res_warm.iter < res_cold.iter
    assert res_warm.objective == pytest.approx(res_cold.objective, abs=1e-6)


def test_warmstart_without_results_warns():
    m, y, z = five_by_five()
    with pytest.warns(UserWarning, match="warmstart"):
        m.warmstart_backend_start_values()


def test_rebuild_after_structure_change_resolves():
    """ipopt.jl:208-221: re-solve after a rebuild."""
    m, y, z = five_by_five()
    m.set_silent()
    m.optimize()
    w = m.variable("w", lb=0)
    m.constraint(w >= 1)
    assert not m.transformation_backend_ready()
    m.optimize()
    assert m.backend.raw_status() == "first_order"
    assert m.value(w) >= 1.0 - 1e-6
    assert m.objective_value() == pytest.approx(FIVE_BY_FIVE, abs=1e-6)


def test_checkpoint_resume(tmp_path):
    """A preempted solve resumes from its checkpoint on disk to the
    oracle."""
    m, y, z = five_by_five()
    b = m.backend
    b.build(m)
    ckpt = str(tmp_path / "ipm_state.npz")
    solver = IpmSolver(b.model, print_level=0, max_iter=8)
    solver.solve(checkpoint_path=ckpt, checkpoint_every=4)
    solver2 = IpmSolver(b.model, print_level=0, max_iter=3000)
    res = solver2.solve(resume_from=ckpt)
    assert res.status == "first_order"
    assert res.objective == pytest.approx(FIVE_BY_FIVE, abs=1e-6)
