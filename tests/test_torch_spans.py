"""The port's spans and counters (``utils/timers.py``) on the CPU.

- the recorder: paths, self times, counters, nothing kept outside a
  recorder;
- a quad-20 solve (band KKT; its regularization ladder retries): the
  step span runs once per iteration plus the step that finds the iterate
  converged, the self times under it add up to it, and so do the
  benchmark readers' six shares of the step; it agrees with
  ``timers["step_total"]``; every try of the ladder factors once;
- no record function is entered without a profiler; under one, the
  spans nest as the code does (the Hessian sweep inside the assembly
  inside the direction inside the step) and hold their sweeps' aten ops,
  and leave nothing on the device's side of the trace;
- the ``trace_dir`` Chrome trace holds the program's spans.
"""
import json

import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.solvers import ipm as tipm
from infiniteexamodels_jl_torch.transcribe import transcribe
from infiniteexamodels_jl_torch.utils import timers
from portbench import program_spans

SWEEPS = ("ad.obj_and_grad", "ad.cons_and_jac", "ad.kkt_vals", "ad.obj",
          "ad.cons")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def quad20():
    model, _ = transcribe(tmodels.quad(num_supports=20), device="cpu")
    res = IpmSolver(model, print_level=0, linear_solver="auto").solve()
    assert res.status == "first_order"
    return res


def _hover11():
    model, _ = transcribe(tmodels.hovercraft(num_supports=11), device="cpu")
    return IpmSolver(model, print_level=0, linear_solver="auto")


def _in_step(res, name):
    return [t for n, t in program_spans.in_step(res) if n == name]


def test_the_recorder_keeps_paths_self_times_and_counts():
    with timers.span("outside"):
        timers.count("outside")          # no recorder: nothing kept
    with timers.Recorder() as rec:
        with timers.span("a"):
            with timers.span("b"):
                timers.count("n", 2)
            with timers.phases() as phase:
                phase("c")
                phase("d")
            with timers.span("b"):
                timers.count("n")
    spans = rec.spans()
    assert set(spans) == {"a", "a/b", "a/c", "a/d"}
    assert spans["a/b"]["calls"] == 2 and spans["a"]["calls"] == 1
    assert rec.counts == {"n": 3}
    assert rec.totals["a"][1] == sum(own for _, _, own
                                     in rec.totals.values())
    assert rec.stack == []
    with timers.span("outside"):
        pass
    assert "outside" not in rec.spans()


def test_step_spans_follow_the_iterations(quad20):
    """No restoration: one step span per iteration, and one more for the
    step that finds the iterate converged (it does not advance ``iter``);
    the timers keep their two keys."""
    assert not any("ipm.restore" in p for p in quad20.spans)
    assert quad20.spans["ipm.solve/ipm.step"]["calls"] == quad20.iter + 1
    assert set(quad20.timers) == {"step_total", "first_chunk"}
    assert quad20.spans["ipm.solve"]["calls"] == 1


def test_self_times_partition_the_step(quad20):
    step = quad20.spans["ipm.solve/ipm.step"]
    under = sum(t["self_s"] for _, t in program_spans.in_step(quad20))
    assert abs(under - step["s"]) <= 1e-6
    shares = program_spans.step_shares_ms(quad20)
    assert set(shares) == {"ad.sweeps", "kkt.assemble_self", "kkt.factor",
                           "kkt.solve", "ipm.self", "ipm.host_sync"}
    assert all(v > 0 for v in shares.values()), shares
    per_step = 1e3 * step["s"] / quad20.iter
    assert abs(sum(shares.values()) - per_step) <= 1e-3 / quad20.iter
    # the Hessian sweep is a part of the sweeps' share
    assert 0 < program_spans.step_ms(quad20, "ad.kkt_vals") \
        < shares["ad.sweeps"]


def test_step_span_agrees_with_step_total(quad20):
    step = quad20.spans["ipm.solve/ipm.step"]["s"]
    assert abs(step - quad20.timers["step_total"]) <= \
        0.02 * quad20.timers["step_total"]


def test_every_ladder_try_factors_once(quad20):
    regs = quad20.counts["kkt.regularizations"]
    assert regs > 0
    factors = sum(t["calls"] for t in _in_step(quad20, "kkt.factor"))
    assert factors == quad20.spans["ipm.solve/ipm.step"]["calls"] + regs
    assert sum(t["calls"] for t in _in_step(quad20, "kkt.assemble")) == \
        factors
    # quad's band KKT ends each factorization in K1's launches
    assert all("kkt.factor/k1.chol_linv" in p for p, t in quad20.spans.items()
               if p.endswith("k1.chol_linv"))
    assert _in_step(quad20, "k1.chol_linv")


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    orig = timers.record_function

    def counting(name):
        entered.append(name)
        return orig(name)

    monkeypatch.setattr(timers, "record_function", counting)
    res = _hover11().solve()
    assert res.status == "first_order" and res.spans
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _hover11().solve()
    assert "ipm.step" in entered and "ad.kkt_vals" in entered


def test_spans_nest_in_the_trace():
    solver = _hover11()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            res = solver.solve()
    assert res.status == "first_order"
    events = prof.events()

    def named(name):
        out = [e for e in events if e.name == name]
        assert out, name
        return out

    def inside(e, names):
        return any(o.time_range.start <= e.time_range.start
                   and e.time_range.end <= o.time_range.end
                   and o.thread == e.thread for o in named(names))

    # an operator's record, not a user annotation, whose copy on the
    # device's timeline a trace reader would take for device work
    assert not any(e.is_user_annotation for e in named("ipm.step"))
    assert named("outer")[0].is_user_annotation
    for e in named("ad.kkt_vals"):
        assert inside(e, "kkt.assemble")
    for e in named("kkt.assemble"):
        assert inside(e, "ipm.direction") and inside(e, "ipm.step")
    for e in named("ipm.step"):
        assert inside(e, "ipm.solve") and inside(e, "outer")
    for name in SWEEPS:
        for e in named(name):
            kids = [k for k in e.cpu_children if k.name.startswith("aten::")]
            assert kids, name
            for k in kids:
                assert e.time_range.start <= k.time_range.start
                assert k.time_range.end <= e.time_range.end


def test_trace_dir_trace_holds_the_program_spans(tmp_path):
    m, _ = transcribe(tmodels.hovercraft(num_supports=11), device="cpu")
    res = IpmSolver(m, print_level=0, linear_solver="auto").solve(
        trace_dir=tmp_path)
    assert res.status == "first_order"
    with open(tmp_path / tipm.TRACE_FILE) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"ipm.solve", "ipm.step", "ipm.eval", "ipm.barrier",
            "ipm.direction", "ipm.line_search", "ipm.update", "ipm.trial",
            "ipm.host_sync", "kkt.assemble", "kkt.factor", "kkt.solve",
            "k1.chol_linv", "ad.kkt_vals", "ad.obj_and_grad",
            "ad.cons_and_jac"} <= names
