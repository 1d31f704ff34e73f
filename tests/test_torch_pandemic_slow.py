"""The JAX package's three slow pandemic solves (tests/test_models.py:
test_pandemic, test_pandemic_limit_cycle_escape and
test_pandemic_stall_recalc_100x32) through the port, with the JAX tests'
options and bounds.  Slow, as in the JAX package: they iterate for hundreds
of steps (the IPM's endgame: the near-optimal visit counter, the best
iterate's restore, the stall-triggered least-squares dual recalc).

The file imports neither JAX nor the JAX package (the oracle is copied from
tests/test_models.py ORACLES), so it runs on a host without them too.  The
solves run on the CUDA card where there is one, else on the CPU:

    python -m pytest -m slow tests/test_torch_pandemic_slow.py
    python3 -m pytest --noconftest -o addopts="" -m slow \\
        tests/test_torch_pandemic_slow.py      # on the card, no JAX there
"""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.models import pandemic
from infiniteexamodels_jl_torch.solvers import IpmSolver

PANDEMIC51x4 = 29.137955008938995       # tests/test_models.py ORACLES
DEVICE = "cuda" if torch.cuda.is_available() else "cpu"


def solve(m, **opts):
    m.set_transformation_backend(ExaTranscriptionBackend(
        IpmSolver, device=DEVICE, linear_solver="auto", tol=1e-6, **opts))
    m.set_silent()
    return m.optimize()


def values(m, name):
    return np.asarray(m.value(next(v for v in m.infinite_vars
                                   if v.name == name)))


@pytest.mark.slow
def test_pandemic():
    """(51,4): first_order at the oracle to 1e-3 (the degenerate
    multiplier ray fixes the primal optimum only to ~tol), the cap
    i <= 0.02 and 0 <= u <= 0.8 held."""
    m = pandemic(num_supports=51, num_scenarios=4)
    res = solve(m, max_iter=800)
    assert res.status == "first_order"
    assert res.primal_feas <= 1e-4
    assert m.objective_value() == pytest.approx(PANDEMIC51x4, abs=1e-3)
    ivals = values(m, "i")
    assert ivals.shape[1] == 4
    assert np.all(ivals <= 0.02 + 1e-5)
    uv = values(m, "u")
    assert np.all(uv >= -1e-6) and np.all(uv <= 0.8 + 1e-6)


@pytest.mark.slow
def test_pandemic_limit_cycle_escape():
    """(100,8), the reference's sweep point: the endgame's limit cycle ends
    "acceptable" at the best iterate (not the last one)."""
    m = pandemic(num_supports=100, num_scenarios=8)
    res = solve(m, max_iter=600)
    assert res.status == "acceptable"
    assert res.iter < 600
    assert res.primal_feas <= 1e-5
    assert res.dual_feas <= 1e-2
    assert m.objective_value() == pytest.approx(30.346, abs=5e-3)


@pytest.mark.slow
def test_pandemic_stall_recalc_100x32():
    """(100,32) with the elastic cap (rho 500), the least-squares dual
    start and the stall-triggered recalc: "acceptable" with a dual
    certificate du <= 1e-2 near the optimum."""
    m = pandemic(num_supports=100, num_scenarios=32, elastic_rho=500.0)
    res = solve(m, max_iter=900, dual_init="lsq", recalc_y_stall=True)
    assert res.status == "acceptable"
    assert res.primal_feas <= 1e-5
    assert res.dual_feas <= 1e-2
    assert m.objective_value() == pytest.approx(31.16, abs=0.2)
