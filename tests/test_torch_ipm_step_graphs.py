"""The IPM step's segments as CUDA graphs (``solvers/ipm.py``:
``IpmSolver._step_graphs``, a ``utils/cuda_graphs.py`` ``GraphCache``) on
the CPU.

A CPU solver runs every segment eagerly, so these tests force its cache on
and stand in for the capture with the AD sweeps' ``ReplayOnCPU``: a
"replay" runs the segment again on the graph's static inputs and writes
its values into the graph's own outputs.  The dispatch, the packing of
the arguments into the static inputs and the clones of the packed outputs
are the program's own.  The sweeps and the KKT solve stay eager here.

- a whole solve through the graph path equals the eager solve bit for bit,
  state by state (iterates, bounds, filter, counters, status and every
  ``log_*`` field), on quad-12, on opf at 10 scenarios (slacks, SOC
  steps) and on quad-12 in the "mixed" f32 step set;
- the first solve captures each segment once per step set, and a second
  solve only replays;
- a re-solve after new parameter values, and one after ``set_options``,
  capture anew and give the eager answers: no stale graph is replayed;
- a CPU solve, and a solve over a mesh, capture nothing;
- the benchmark's ``ipm.graph_replay_share`` reads the counters.

The same checks with real graphs on the card are in
``tests/test_torch_ipm_step_graphs_cuda.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.parallel import make_mesh, shard_model
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.solvers.ipm import IpmState
from infiniteexamodels_jl_torch.transcribe import transcribe
from infiniteexamodels_jl_torch.utils import cuda_graphs
from portbench import registry
from test_torch_sweep_graphs import ReplayOnCPU, _run_of

OPF_SEED = 2 ** 31 + 901
CASES = {
    "quad-12": (lambda: tmodels.quad(num_supports=12), {}),
    "opf-10": (lambda: tmodels.opf(num_supports=10, seed=OPF_SEED), {}),
    "quad-12-mixed": (lambda: tmodels.quad(num_supports=12),
                      {"factor_dtype": "mixed"}),
}
# the segments every step runs (the barrier loop's pass runs where mu falls)
SEGMENTS = ("eval", "direction", "system", "finish", "trial_point", "trial",
            "update")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solver(case):
    make, opts = CASES[case]
    model, _ = transcribe(make(), device="cpu")
    return IpmSolver(model, print_level=0, linear_solver="auto", tol=1e-6,
                     **opts)


@pytest.fixture
def graphed(monkeypatch):
    """Makes a CPU solver's step take the graph path, through
    ``ReplayOnCPU``."""
    monkeypatch.setattr(cuda_graphs, "CapturedCall", ReplayOnCPU)

    def on(solver):
        made = solver._step_graphs

        def forced(consts):
            cache = made(consts)
            cache.on = True
            return cache

        monkeypatch.setattr(solver, "_step_graphs", forced)
        return solver
    return on


def _recorded(solver):
    """The states the solver's steps return, copied as they come."""
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
    for name in ("solution", "multipliers", "multipliers_L",
                 "multipliers_U"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert len(states_a) == len(states_b) > 0
    for k, (u, v) in enumerate(zip(states_a, states_b)):
        for field, s, t in zip(IpmState._fields, u, v):
            assert s.dtype == t.dtype and torch.equal(s, t), (k, field)


@pytest.mark.parametrize("case", list(CASES))
def test_a_graphed_solve_equals_the_eager_solve(case, graphed):
    eager = _solver(case)
    eager_states = _recorded(eager)
    want = eager.solve()
    solver = graphed(_solver(case))
    states = _recorded(solver)
    got = solver.solve()
    _same_solve(got, want, states, eager_states)
    assert got.counts["ipm.eager_segments"] == 0
    assert got.counts["ipm.graph_replays"] > 0
    if case == "opf-10":
        # the path through the second-order correction and the slacks
        assert got.counts["ipm.soc_trials"] > 0
        assert solver.model.ncon > 0


@pytest.mark.parametrize("case", ["quad-12", "quad-12-mixed"])
def test_one_capture_per_segment_then_replays(case, graphed):
    solver = graphed(_solver(case))
    first = solver.solve()
    graphs = dict(solver._graphs.graphs)
    tags = {key[0] for key in graphs}
    assert set(SEGMENTS) <= tags <= set(SEGMENTS) | {"barrier"}
    # one graph per segment and step set: the f32 steps key their own
    # update (``can_demote``)
    sets = 2 if case.endswith("mixed") else 1
    assert len(graphs) == len(tags) + (sets - 1)
    assert first.counts["ipm.graph_captures"] == len(graphs)
    second = solver.solve()
    assert second.iter == first.iter
    assert np.array_equal(second.solution, first.solution)
    assert second.counts["ipm.graph_captures"] == 0
    assert second.counts["ipm.eager_segments"] == 0
    assert second.counts["ipm.graph_replays"] == (
        first.counts["ipm.graph_captures"]
        + first.counts["ipm.graph_replays"])
    assert solver._graphs.graphs == graphs      # the same graphs, replayed


def _new_values(model):
    rng = np.random.default_rng(7)
    for par in model.core.parameters:
        model.set_parameter(par, rng.uniform(0.5, 1.0, par.length))


@pytest.mark.parametrize("change", ["parameters", "options"])
def test_a_re_solve_after_a_change_replays_no_stale_graph(change, graphed):
    solver = graphed(_solver("quad-12"))
    eager = _solver("quad-12")
    solver.solve()
    eager.solve()
    before = solver._graphs
    if change == "parameters":
        for s in (solver, eager):
            _new_values(s.model)
    else:
        for s in (solver, eager):
            s.set_options(kappa_mu=0.3, tol=1e-7)
    states, eager_states = _recorded(solver), _recorded(eager)
    got, want = solver.solve(), eager.solve()
    _same_solve(got, want, states, eager_states)
    assert solver._graphs is not before
    assert got.counts["ipm.graph_captures"] >= len(SEGMENTS)


def test_a_host_option_keeps_the_graphs(graphed):
    solver = graphed(_solver("quad-12"))
    solver.solve()
    before = solver._graphs
    res = solver.solve(max_iter=100, print_level=0)
    assert solver._graphs is before
    assert res.counts["ipm.graph_captures"] == 0


@pytest.fixture
def one_rank_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("where", ["cpu", "mesh"])
def test_the_cpu_and_a_mesh_capture_nothing(where, request):
    solver = _solver("quad-12")
    if where == "mesh":
        mesh = request.getfixturevalue("one_rank_mesh")
        shard_model(solver.model, mesh)
        solver = IpmSolver(solver.model, print_level=0,
                           linear_solver="auto", tol=1e-6)
    res = solver.solve()
    assert res.status == "first_order"
    assert not solver._graphs.on and solver._graphs.graphs == {}
    assert solver._graphs_for[1] is getattr(solver.model, "mesh", None)
    assert res.counts["ipm.graph_captures"] == 0
    assert res.counts["ipm.graph_replays"] == 0
    assert res.counts["ipm.eager_segments"] >= len(SEGMENTS) * res.iter
    reader = registry.reader("ipm.graph_replay_share")
    assert reader(_run_of(res)) == 0.0


@pytest.mark.parametrize("counts,share", [
    ({}, None),                                   # a program without them
    ({"ipm.graph_captures": 0, "ipm.graph_replays": 0,
      "ipm.eager_segments": 0}, None),
    ({"ipm.eager_segments": 70}, 0.0),
    ({"ipm.graph_captures": 6, "ipm.graph_replays": 64}, 1.0),
    ({"ipm.graph_replays": 30, "ipm.eager_segments": 10}, 0.75)])
def test_the_replay_share_reads_the_counters(counts, share):
    res = SimpleNamespace(iter=13, spans={"ipm.solve": {}}, counts=counts)
    assert registry.reader("ipm.graph_replay_share")(_run_of(res)) == share
