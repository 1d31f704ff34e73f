"""The AD sweeps' CUDA graphs (``ops/model.py``) on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_sweep_graphs_cuda.py

- quad-1000 and opf-1000: each sweep's replay, and the f32 Hessian
  sweep's, equals its eager body bit for bit, at the point it was captured
  at and at another;
- a graph survives ``set_parameter`` and ``refresh_from_core`` (and reads
  their new ``theta`` and ``x0``), and ``_place`` drops it;
- a model sharded over a mesh captures nothing;
- a graph that dies in a cycle while another sweep is captured is
  destroyed after the capture, not inside it (which would invalidate it);
- a quad-1000 solve with graphs takes the eager solve's iterations to the
  same objective, bit for bit, within 1e-6 of the JAX CPU path's
  568.839978, and every sweep of its re-solve is a replay.
"""
import gc

import numpy as np
import pytest
import torch
import torch.distributed as dist

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.ops.model import SweepGraph
from infiniteexamodels_jl_torch.parallel import make_mesh, shard_model
from infiniteexamodels_jl_torch.transcribe import transcribe
from infiniteexamodels_jl_torch.utils import timers

QUAD1000_OBJECTIVE = 568.839978   # the JAX CPU path, tol 1e-6
MODELS = {"quad-1000": lambda: tmodels.quad(num_supports=1000),
          "opf-1000": lambda: tmodels.opf(num_supports=1000)}
SWEEPS = ("obj", "cons", "obj_and_grad", "cons_and_jac", "kkt_vals",
          "kkt_vals_f32")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request, card):
    m, _ = transcribe(MODELS[request.param](), device=card)
    assert m._graphed
    return m


def _flat(out):
    return [out] if torch.is_tensor(out) else list(out)


def _point(m, seed):
    g = torch.Generator(device=m.device).manual_seed(seed)

    def rnd(n):
        return torch.rand(n, generator=g, dtype=m.dtype, device=m.device)

    return dict(x=m.x0 + 0.1 * rnd(m.nvar), lam=rnd(m.ncon) - 0.5,
                sigma=torch.tensor(0.5 + seed, dtype=m.dtype,
                                   device=m.device),
                d=1.0 + rnd(m.ncon))


def _call(m, sweep, p, eager=False):
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


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", SWEEPS)
def test_a_replay_equals_its_eager_body(model, sweep):
    p1, p2 = _point(model, 1), _point(model, 2)
    with timers.Recorder() as rec:
        first = _call(model, sweep, p1)
        kept = [t.clone() for t in first]
        second = _call(model, sweep, p2)
        again = _call(model, sweep, p1)
    assert rec.counts == {"ad.graph_captures": 1, "ad.graph_replays": 2}
    assert _equal(first, _call(model, sweep, p1, eager=True))
    assert _equal(second, _call(model, sweep, p2, eager=True))
    assert _equal(again, kept) and _equal(first, kept)


@pytest.mark.cuda
def test_a_graph_survives_new_data_and_place_drops_it(card):
    m, _ = transcribe(tmodels.quad(num_supports=1000), device=card)
    p = _point(m, 1)
    for s in SWEEPS:
        _call(m, s, p)
    graphs = dict(m._graphs)
    assert len(graphs) == len(SWEEPS)
    rng = np.random.default_rng(0)
    for par in m.core.parameters:
        m.set_parameter(par, rng.uniform(0.5, 1.0, par.length))
    for s in SWEEPS:
        assert _equal(_call(m, s, p), _call(m, s, p, eager=True)), s
    m.core.set_x0_flat(m.core.x0 + rng.uniform(0.5, 1.0, m.nvar))
    m.refresh_from_core()
    p["x"] = m.x0
    for s in SWEEPS:
        assert _equal(_call(m, s, p), _call(m, s, p, eager=True)), s
    assert m._graphs == graphs            # the same graphs, replayed
    m._place(None)
    assert m._graphs == {}


@pytest.mark.cuda
def test_a_sharded_model_captures_nothing(card, tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        m, _ = transcribe(tmodels.quad(num_supports=1000), device=card)
        shard_model(m, make_mesh(device=card))
        p = _point(m, 1)
        with timers.Recorder() as rec:
            for s in SWEEPS:
                _call(m, s, p)
    finally:
        dist.destroy_process_group()
    assert not m._graphed and m._graphs == {}
    assert rec.counts == {"ad.eager_sweeps": len(SWEEPS)}


@pytest.mark.cuda
def test_no_collection_falls_inside_a_capture(card):
    m, _ = transcribe(tmodels.quad(num_supports=100), device=card)
    p = _point(m, 1)
    _call(m, "obj", p)
    spare = list(m._graphs)
    args = (p["x"], m.theta)

    def body(x, theta):
        if torch.cuda.is_current_stream_capturing() and spare:
            # the obj sweep's graph dies in a cycle, and the allocations
            # after it make a collection due at once
            cycle = [m._graphs.pop(spare.pop())]
            cycle.append(cycle)
            del cycle
            [[] for _ in range(1000)]
        return m._eager_cons(x, theta)

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        g = SweepGraph(body, args, {})
    finally:
        gc.set_threshold(*threshold)
    assert not spare and m._graphs == {}
    gc.collect()                          # the dead graph goes here
    assert _equal(_flat(g(args)), _flat(m._eager_cons(*args)))


def _solve(card, graphed):
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.solvers import IpmSolver

    m = tmodels.quad(num_supports=1000)
    backend = ExaTranscriptionBackend(IpmSolver, device=card,
                                      linear_solver="auto", tol=1e-6,
                                      print_level=0)
    m.set_transformation_backend(backend)
    backend.build(m)
    backend.model._graphed = graphed
    first = backend.optimize(m)
    return first, backend.optimize(m)


@pytest.mark.cuda
def test_a_quad_1000_solve_matches_the_eager_solve(card):
    eager, eager_warm = _solve(card, False)
    first, warm = _solve(card, True)
    assert first.status == eager.status == "first_order"
    assert first.iter == eager.iter and warm.iter == eager_warm.iter
    assert first.objective == eager.objective
    assert warm.objective == eager_warm.objective
    rel = abs(first.objective - QUAD1000_OBJECTIVE) / QUAD1000_OBJECTIVE
    assert rel <= 1e-6, first.objective
    assert first.counts["ad.graph_captures"] >= 1
    assert "ad.graph_captures" not in warm.counts
    assert "ad.eager_sweeps" not in warm.counts
    assert warm.counts["ad.graph_replays"] > 0
    assert eager.counts.get("ad.graph_replays", 0) == 0
