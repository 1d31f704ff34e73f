"""The IPM step's segments as CUDA graphs (``solvers/ipm.py``) on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_ipm_step_graphs_cuda.py

- quad-1000, opf-1000 (slacks, SOC steps) and quad-1000 in the "mixed"
  f32 step set: a solve whose segments replay from their graphs equals
  the solve with the segments eager (the sweeps and the KKT solve graphed
  in both), state by state, bit for bit;
- a warm re-solve only replays, and the benchmark's
  ``ipm.graph_replay_share`` reads 1.0 on it;
- a re-solve at new parameter values captures anew and equals the eager
  re-solve;
- a solver over a model sharded on a mesh captures nothing.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.parallel import make_mesh, shard_model
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.solvers.ipm import IpmState
from infiniteexamodels_jl_torch.transcribe import transcribe

CASES = {
    "quad-1000": (lambda: tmodels.quad(num_supports=1000), {}),
    "opf-1000": (lambda: tmodels.opf(num_supports=1000), {}),
    "quad-1000-mixed": (lambda: tmodels.quad(num_supports=1000),
                        {"factor_dtype": "mixed"}),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _solver(card, case, graphed=True):
    make, opts = CASES[case]
    model, _ = transcribe(make(), device=card)
    solver = IpmSolver(model, print_level=0, linear_solver="auto", tol=1e-6,
                       **opts)
    if not graphed:
        made = solver._step_graphs

        def eager(consts):
            cache = made(consts)
            cache.on = False
            return cache

        solver._step_graphs = eager
    return solver


def _recorded(solver):
    states = []
    step = solver._step

    def recording(st, consts, kkt=None):
        new = step(st, consts, kkt)
        states.append([t.clone() for t in new])
        return new

    solver._step = recording
    return states


def _same_solve(a, b, states_a, states_b):
    assert (a.status, a.iter, a.objective) == (b.status, b.iter, b.objective)
    assert np.array_equal(a.solution, b.solution)
    assert np.array_equal(a.multipliers, b.multipliers)
    assert len(states_a) == len(states_b) > 0
    for k, (u, v) in enumerate(zip(states_a, states_b)):
        for field, s, t in zip(IpmState._fields, u, v):
            assert s.dtype == t.dtype and torch.equal(s, t), (k, field)


def _share(res):
    replays = res.counts.get("ipm.graph_replays", 0)
    return replays / (replays + res.counts.get("ipm.eager_segments", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_a_graphed_solve_equals_the_eager_solve(card, case):
    eager = _solver(card, case, graphed=False)
    eager_states = _recorded(eager)
    want = eager.solve()
    solver = _solver(card, case)
    states = _recorded(solver)
    got = solver.solve()
    assert got.status == "first_order"
    _same_solve(got, want, states, eager_states)
    assert got.counts["ipm.graph_captures"] >= 5
    assert got.counts["ipm.eager_segments"] == 0
    assert want.counts["ipm.graph_replays"] == 0
    if case == "opf-1000":
        assert got.counts["ipm.soc_trials"] > 0
    warm = solver.solve()
    assert (warm.iter, warm.objective) == (got.iter, got.objective)
    assert warm.counts["ipm.graph_captures"] == 0
    assert _share(warm) == 1.0


@pytest.mark.cuda
def test_new_parameter_values_capture_anew(card):
    solver = _solver(card, "quad-1000")
    eager = _solver(card, "quad-1000", graphed=False)
    solver.solve()
    eager.solve()
    before = solver._graphs
    rng = np.random.default_rng(3)
    values = [rng.uniform(0.5, 1.0, par.length)
              for par in solver.model.core.parameters]
    for s in (solver, eager):
        for par, v in zip(s.model.core.parameters, values):
            s.model.set_parameter(par, v)
    states, eager_states = _recorded(solver), _recorded(eager)
    got, want = solver.solve(), eager.solve()
    _same_solve(got, want, states, eager_states)
    assert solver._graphs is not before
    assert got.counts["ipm.graph_captures"] >= 5


@pytest.mark.cuda
def test_a_sharded_model_captures_nothing(card, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        m, _ = transcribe(tmodels.quad(num_supports=100), device=card)
        shard_model(m, make_mesh(device=card))
        solver = IpmSolver(m, print_level=0, linear_solver="auto", tol=1e-6)
        res = solver.solve()
    finally:
        dist.destroy_process_group()
    assert res.status == "first_order"
    assert not solver._graphs.on and solver._graphs.graphs == {}
    assert res.counts["ipm.graph_captures"] == 0
    assert res.counts["ipm.graph_replays"] == 0
    assert _share(res) == 0.0
