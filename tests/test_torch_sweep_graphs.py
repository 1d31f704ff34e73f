"""The AD sweeps' CUDA graphs (``ops/model.py``'s ``SimdModel._graphs``, a
``utils/cuda_graphs.py`` ``GraphCache``) on the CPU.

A CPU model runs every sweep eagerly, so these tests check the plumbing
around the capture with a stand-in for it (``ReplayOnCPU``): a "replay"
runs the sweep's eager body again on the graph's static inputs and writes
its values into the graph's own output tensors, as a CUDA graph's replay
does.  The dispatch, the copies into the static inputs and the clones of
the outputs are the program's own.  On quad-12 and opf at 10 scenarios:

- each of the five sweeps, and the f32 Hessian sweep, through the graph
  path and through the plain CPU path equals its eager body bit for bit;
- an output kept from one call is unchanged after a call at another ``x``,
  though the graph's own outputs were overwritten;
- a new ``theta`` (``set_parameter``) and a new ``x0`` are picked up;
- one capture per sweep and dtype, replays after; ``_place`` drops them;
- on the CPU, and on a model sharded over a mesh, nothing is captured;
- the benchmark's ``ad.graph_replay_share`` reads the counters.

The same checks with real graphs on the card are in
``tests/test_torch_sweep_graphs_cuda.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.parallel import make_mesh, shard_model
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.transcribe import transcribe
from infiniteexamodels_jl_torch.utils import cuda_graphs, timers
from portbench import registry

OPF_SEED = 2 ** 31 + 901
MODELS = {"quad": lambda: tmodels.quad(num_supports=12),
          "opf": lambda: tmodels.opf(num_supports=10, seed=OPF_SEED)}
SWEEPS = ("obj", "cons", "obj_and_grad", "cons_and_jac", "kkt_vals",
          "kkt_vals_f32")


class ReplayOnCPU(cuda_graphs.CapturedCall):
    """The capture's stand-in on the CPU: the outputs are the body's on the
    static inputs, and a replay writes the body's new values into them."""

    def __init__(self, body, args, kwargs):
        self.inputs = [a.detach().clone() for a in args]
        self.outputs = body(*self.inputs, **kwargs)
        outputs = _flat(self.outputs)

        class Graph:
            def replay(_):
                for out, new in zip(outputs, _flat(
                        body(*self.inputs, **kwargs))):
                    out.copy_(new)

        self.graph = Graph()


def _flat(out):
    return [out] if torch.is_tensor(out) else list(out)


def _build(name):
    model, _ = transcribe(MODELS[name](), device="cpu")
    return model


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=sorted(MODELS))
def model(request):
    return _build(request.param)


@pytest.fixture
def graphed(monkeypatch):
    """Makes a CPU model take the graph path, through ``ReplayOnCPU``."""
    monkeypatch.setattr(cuda_graphs, "CapturedCall", ReplayOnCPU)

    def on(m):
        m._graphs.on = True
        return m
    return on


def _point(m, seed):
    """A point of the sweeps' arguments: ``x`` near the start values,
    seeded multipliers and condensing weights."""
    g = torch.Generator().manual_seed(seed)

    def rnd(n):
        return torch.rand(n, generator=g, dtype=m.dtype)

    return dict(x=m.x0 + 0.1 * rnd(m.nvar), lam=rnd(m.ncon) - 0.5,
                sigma=torch.tensor(0.5 + seed, dtype=m.dtype),
                d=1.0 + rnd(m.ncon))


def _call(m, sweep, p, eager=False):
    """One sweep at the point ``p``: the public method, or with ``eager``
    its eager body; always a list of tensors."""
    pre = "_eager_" if eager else ""
    name = "kkt_vals" if sweep == "kkt_vals_f32" else sweep
    fn = getattr(m, pre + name)
    if name != "kkt_vals":
        return _flat(fn(p["x"], m.theta))
    dtype = torch.float32 if sweep == "kkt_vals_f32" else None
    return _flat(fn(p["x"], m.theta, p["lam"], p["sigma"], p["d"],
                    dtype=dtype))


def _equal(a, b):
    return len(a) == len(b) and all(
        u.dtype == v.dtype and torch.equal(u, v) for u, v in zip(a, b))


def _counted(fn):
    with timers.Recorder() as rec:
        fn()
    return rec.counts


@pytest.mark.parametrize("route", ["graph", "eager"])
@pytest.mark.parametrize("sweep", SWEEPS)
def test_a_sweep_equals_its_eager_body(model, graphed, sweep, route):
    if route == "graph":
        graphed(model)
    p = _point(model, 1)
    want = _call(model, sweep, p, eager=True)
    assert _equal(_call(model, sweep, p), want)      # the capture's call
    assert _equal(_call(model, sweep, p), want)      # a replay
    assert len(model._graphs.graphs) == (route == "graph")


@pytest.mark.parametrize("sweep", SWEEPS)
def test_a_kept_output_survives_the_next_call(model, graphed, sweep):
    graphed(model)
    p1, p2 = _point(model, 1), _point(model, 2)
    kept = _call(model, sweep, p1)
    copy = [t.clone() for t in kept]
    second = _call(model, sweep, p2)
    assert _equal(kept, copy)
    assert _equal(second, _call(model, sweep, p2, eager=True))
    assert not _equal(second, copy)
    # the graph's own outputs hold the second call's values: without the
    # clones the first call's outputs would have changed with them
    (g,) = model._graphs.graphs.values()
    assert _equal(_flat(g.outputs), second)


def test_new_theta_and_x0_are_picked_up(model, graphed):
    graphed(model)
    p = _point(model, 1)
    before = {s: _call(model, s, p) for s in SWEEPS}
    rng = np.random.default_rng(0)
    x0 = model.core.x0 + rng.uniform(0.5, 1.0, model.nvar)
    model.set_x0(x0)
    p["x"] = model.x0
    for par in model.core.parameters:      # quad's; opf has none
        model.set_parameter(par, rng.uniform(0.5, 1.0, par.length))
    for s in SWEEPS:
        got = _call(model, s, p)
        assert _equal(got, _call(model, s, p, eager=True)), s
        assert not _equal(got, before[s]), s


def test_one_capture_per_sweep_then_replays(model, graphed):
    graphed(model)
    p = _point(model, 1)

    def every_sweep_twice():
        for _ in range(2):
            for s in SWEEPS:
                _call(model, s, p)

    assert _counted(every_sweep_twice) == {
        "ad.graph_captures": len(SWEEPS), "ad.graph_replays": len(SWEEPS)}
    model._place(None)            # new gather tables: the graphs go
    assert model._graphs.graphs == {}
    graphed(model)                # (``_place`` judged the CPU anew)
    assert _counted(every_sweep_twice)["ad.graph_captures"] == len(SWEEPS)


@pytest.fixture
def one_rank_mesh(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("where", ["cpu", "mesh"])
def test_the_cpu_and_a_mesh_capture_nothing(model, where, request):
    if where == "mesh":
        shard_model(model, request.getfixturevalue("one_rank_mesh"))
    p = _point(model, 1)

    def every_sweep():
        for s in SWEEPS:
            _call(model, s, p)

    assert not model._graphs.on
    assert _counted(every_sweep) == {"ad.eager_sweeps": len(SWEEPS)}
    assert model._graphs.graphs == {}


def _run_of(res):
    """What a benchmark reader reads of a run whose last request is
    ``res``."""
    solver = SimpleNamespace(results=res)
    return SimpleNamespace(system=SimpleNamespace(solver=lambda: solver))


@pytest.mark.parametrize("counts,share", [
    ({}, None),                                   # a program without them
    ({"ad.eager_sweeps": 40}, 0.0),
    ({"ad.graph_captures": 6, "ad.graph_replays": 34}, 1.0),
    ({"ad.graph_replays": 30, "ad.eager_sweeps": 10}, 0.75)])
def test_the_replay_share_reads_the_counters(counts, share):
    res = SimpleNamespace(iter=13, spans={"ipm.solve": {}}, counts=counts)
    assert registry.reader("ad.graph_replay_share")(_run_of(res)) == share


def test_a_cpu_solve_replays_no_sweep():
    model = _build("quad")
    res = IpmSolver(model, print_level=0, linear_solver="auto").solve()
    assert res.status == "first_order"
    assert "ad.graph_captures" not in res.counts
    assert res.counts["ad.eager_sweeps"] >= 3 * res.iter
    assert registry.reader("ad.graph_replay_share")(_run_of(res)) == 0.0
