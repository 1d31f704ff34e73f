"""The band and scenario KKT's solve as a CUDA graph
(``solvers/block_tridiag.py``: ``BlockTridiagKKT.solve``, ``_Placement``,
through ``utils/cuda_graphs.py``'s ``GraphCache``) on the CPU.

A CPU backend solves eagerly, so these tests take the graph path with the
AD sweeps' stand-in for the capture (``ReplayOnCPU``): a "replay" runs the
eager solve again on the graph's static input and writes its values into
the graph's own output.  The placement of the factorization, the
generation check, the dispatch, the copy in and the clone out are the
program's own.  On quad-12 (band, BCR) and opf at 100 scenarios
(block-diagonal with a border of 6; at fewer than ~64 scenarios the
structure analysis finds no border and the dense KKT solves):

- the graph path equals the eager factor and solve bit for bit;
- after a second factorization (a regularization retry) the solve
  follows it, and a solve with the older one raises;
- an output kept from one solve survives the next replay;
- the IPM's f32 view factors into placements and graphs of its own and
  leaves the f64 view's solves unchanged; one capture per factor dtype,
  replays after;
- a whole IPM solve through the graph path takes the eager solve's
  iterations to the same objective, bit for bit (quad's "mixed" too);
- on the CPU, and for the sharded backends over a mesh, nothing is
  placed or captured;
- the benchmark's ``kkt.solve_graph_replay_share`` reads the counters.

The same checks with real graphs on the card are in
``tests/test_torch_kkt_solve_graph_cuda.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.parallel import make_mesh
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.solvers.band_shard import ShardedBandKKT
from infiniteexamodels_jl_torch.solvers.block_tridiag import BlockTridiagKKT
from infiniteexamodels_jl_torch.solvers.scenario_shard import (
    ShardedScenarioKKT)
from infiniteexamodels_jl_torch.transcribe import transcribe
from infiniteexamodels_jl_torch.utils import cuda_graphs, timers
from portbench import registry
from test_torch_sweep_graphs import ReplayOnCPU, _run_of

OPF_SEED = 2 ** 31 + 901
MODELS = {"quad": lambda: tmodels.quad(num_supports=12),
          "opf": lambda: tmodels.opf(num_supports=100, seed=OPF_SEED)}
MODES = {"quad": ("band", 0), "opf": ("block_diag", 6)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(name):
    m, _ = transcribe(MODELS[name](), device="cpu")
    m.name = name
    return m


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    return _model(request.param)


@pytest.fixture
def graphed(monkeypatch):
    """Makes a CPU backend take the graph path, through ``ReplayOnCPU``."""
    monkeypatch.setattr(cuda_graphs, "CapturedCall", ReplayOnCPU)

    def on(kkt):
        kkt._graphs.on = True
        return kkt
    return on


def _kkt(model, **kw):
    kkt = BlockTridiagKKT(model, **kw)
    assert kkt.usable and (kkt.mode, kkt.mB) == MODES[model.name]
    return kkt


def _K(kkt, seed, shift=0.0):
    """An SPD system of ``kkt``'s structure from a seeded point; ``shift``
    adds to the diagonal, as a regularization retry does."""
    m = kkt.model
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=m.dtype)

    x = m.x0 + 0.01 * t(rng.standard_normal(m.nvar))
    return kkt.assemble(x, m.theta, t(0.1 * rng.standard_normal(m.ncon)),
                        1.0, t(rng.uniform(1.0, 3.0, m.ncon)),
                        t(rng.uniform(2.0, 4.0, m.nvar) + shift))


def _rhs(model, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(model.nvar, generator=g, dtype=model.dtype)


def _eager(model, K, rhs, **kw):
    """``K^{-1} rhs`` by a backend that never takes the graph path."""
    kkt = _kkt(model, **kw)
    fac, ok = kkt.factor(K)
    assert bool(ok) and fac.placement is None
    return kkt.solve(fac, rhs)


def _counted(fn):
    with timers.Recorder() as rec:
        fn()
    return rec.counts


@pytest.mark.parametrize("route", ["graph", "eager"])
def test_the_graph_path_equals_the_eager_solve(model, graphed, route):
    kkt = _kkt(model)
    if route == "graph":
        graphed(kkt)
    K, rhs = _K(kkt, 1), _rhs(model, 1)
    want = _eager(model, K, rhs)
    fac, ok = kkt.factor(K)
    assert bool(ok)
    assert torch.equal(kkt.solve(fac, rhs), want)     # the capture's call
    assert torch.equal(kkt.solve(fac, rhs), want)     # a replay
    assert torch.equal(kkt._eager_solve(fac, rhs), want)
    assert (fac.placement is not None) == (route == "graph")
    assert len(kkt._placements) == (route == "graph")


def test_a_retry_is_followed_and_the_older_factorization_raises(
        model, graphed):
    kkt = graphed(_kkt(model))
    K1, K2, rhs = _K(kkt, 1), _K(kkt, 1, shift=10.0), _rhs(model, 1)
    fac1, _ = kkt.factor(K1)
    x1 = kkt.solve(fac1, rhs)
    fac2, _ = kkt.factor(K2)
    x2 = kkt.solve(fac2, rhs)
    assert torch.equal(x2, _eager(model, K2, rhs))
    assert not torch.equal(x2, x1)
    assert fac2.generation == fac1.generation + 1
    with pytest.raises(RuntimeError, match="stale factorization"):
        kkt.solve(fac1, rhs)
    # before its first capture as well
    fac3, _ = kkt.factor(K1)
    with pytest.raises(RuntimeError, match="stale factorization"):
        kkt.solve(fac2, rhs.to(torch.float32))
    assert torch.equal(kkt.solve(fac3, rhs), x1)


def test_a_kept_output_survives_the_next_replay(model, graphed):
    kkt = graphed(_kkt(model))
    K = _K(kkt, 1)
    fac, _ = kkt.factor(K)
    kept = kkt.solve(fac, _rhs(model, 1))
    copy = kept.clone()
    second = kkt.solve(fac, _rhs(model, 2))
    assert torch.equal(kept, copy)
    assert torch.equal(second, _eager(model, K, _rhs(model, 2)))
    (graph,) = kkt._graphs.graphs.values()
    assert torch.equal(graph.outputs, second)


def test_the_f32_view_keeps_its_own_placement(model, graphed):
    kkt = graphed(_kkt(model))
    solver = IpmSolver(model, kkt=kkt, factor_dtype="mixed", print_level=0)
    kkt32 = solver.kkt32
    assert kkt32 is not kkt and kkt32._graphs.on
    K, rhs = _K(kkt, 1), _rhs(model, 1)

    def solves():
        fac, _ = kkt.factor(K)
        x64 = kkt.solve(fac, rhs)
        fac32, _ = kkt32.factor(K)
        x32 = kkt32.solve(fac32, rhs)
        # the f32 factorization overwrote nothing of the f64 one's
        assert torch.equal(kkt.solve(fac, rhs), x64)
        assert torch.equal(kkt32.solve(fac32, rhs), x32)
        return x64, x32

    assert _counted(solves) == {"kkt.solve_graph_captures": 2,
                                "kkt.solve_graph_replays": 2}
    assert _counted(solves) == {"kkt.solve_graph_replays": 4}
    x64, x32 = solves()
    assert sorted(map(str, kkt._placements)) == ["torch.float32",
                                                 "torch.float64"]
    assert kkt32._placements is kkt._placements
    assert kkt32._graphs is kkt._graphs
    assert torch.equal(x64, _eager(model, K, rhs))
    assert torch.equal(x32, _eager(model, K, rhs,
                                   factor_dtype=torch.float32))
    assert not torch.equal(x32, x64)


# opf's "mixed" solve crawls in f32 at this size (~50 s a solve here)
@pytest.mark.parametrize("name,factor_dtype", [
    ("quad", "float64"), ("quad", "mixed"), ("opf", "float64")])
def test_an_ipm_solve_through_the_graph_equals_the_eager_solve(
        name, factor_dtype, graphed):
    model = _model(name)

    def solve(kkt):
        solver = IpmSolver(model, kkt=kkt, print_level=0, tol=1e-6,
                           factor_dtype=factor_dtype)
        return solver.solve()

    eager = solve(_kkt(model))
    kkt = graphed(_kkt(model))
    res = solve(kkt)
    assert res.status == eager.status == "first_order"
    assert res.iter == eager.iter and res.objective == eager.objective
    assert "kkt.solve_graph_captures" not in eager.counts
    assert eager.counts["kkt.eager_solves"] >= eager.iter
    assert "kkt.eager_solves" not in res.counts
    # one graph per factor dtype the solve used
    captures = res.counts["kkt.solve_graph_captures"]
    assert captures == len(kkt._placements) >= 1
    assert res.counts["kkt.solve_graph_replays"] == \
        eager.counts["kkt.eager_solves"] - captures


@pytest.fixture
def one_rank_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("backend", ["cpu", "ShardedBandKKT",
                                     "ShardedScenarioKKT"])
def test_the_cpu_and_the_sharded_backends_capture_nothing(
        model, backend, request):
    if backend == "cpu":
        kkt = _kkt(model)
    else:
        cls = {"ShardedBandKKT": ShardedBandKKT,
               "ShardedScenarioKKT": ShardedScenarioKKT}[backend]
        kkt = cls(model, mesh=request.getfixturevalue("one_rank_mesh"))
        assert kkt.mesh is not None
    K, rhs = _K(kkt, 1), _rhs(model, 1)

    def factor_and_solve_twice():
        fac, _ = kkt.factor(K)
        for _ in range(2):
            kkt.solve(fac, rhs)
        return fac

    assert not kkt._graphs.on
    assert _counted(factor_and_solve_twice) == {"kkt.eager_solves": 2}
    assert kkt._placements == {}
    assert factor_and_solve_twice().placement is None


@pytest.mark.parametrize("counts,share", [
    ({}, None),                                   # a program without them
    ({"kkt.eager_solves": 31}, 0.0),
    ({"kkt.solve_graph_captures": 1, "kkt.solve_graph_replays": 31}, 1.0),
    ({"kkt.solve_graph_replays": 24, "kkt.eager_solves": 8}, 0.75)])
def test_the_replay_share_reads_the_counters(counts, share):
    res = SimpleNamespace(iter=13, spans={"ipm.solve": {}}, counts=counts)
    assert registry.reader("kkt.solve_graph_replay_share")(
        _run_of(res)) == share
