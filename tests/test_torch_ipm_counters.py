"""The IPM's counters of the second-order correction (``ipm.soc_trials``)
and of the condensed solve's iterative refinement (``kkt.refine_rounds``)
on the CPU.

- opf at 10 scenarios (the draw of seed 2**31 + 901; dense KKT, its
  inequality rows slacked) and quad-12 (band KKT), at the benchmark's
  tolerance 1e-6, on one thread (opf's path at this size turns on the
  round-off of the thread count): each counter equals
  what the KKT backend's calls give, counted apart from the solver by
  wrapping the backend's ``factor``, ``solve`` and ``matvec``: a
  direction factors once, solves once and multiplies once, each
  refinement round solves and multiplies once more, and each correction
  solves once more;
- both keys are present at 0 in a solve that had neither;
- counting adds no host read: the solve reads the device as often with
  the counters switched off;
- the benchmark readers' six shares of the step still add up to it.
"""
import pytest
import torch

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.solvers import ipm as tipm
from infiniteexamodels_jl_torch.transcribe import transcribe
from portbench import program_spans

OPF_SEED = 2 ** 31 + 901
CASES = {
    "opf-10": lambda: tmodels.opf(num_supports=10, seed=OPF_SEED),
    "quad-12": lambda: tmodels.quad(num_supports=12),
}
KKT_CALLS = ("factor", "solve", "matvec")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solver(case):
    model, _ = transcribe(CASES[case](), device="cpu")
    return IpmSolver(model, print_level=0, linear_solver="auto", tol=1e-6)


def _wrap_kkt(kkt, calls):
    for name in KKT_CALLS:
        orig = getattr(kkt, name)

        def counted(*args, _orig=orig, _name=name, **kwargs):
            calls[_name] += 1
            return _orig(*args, **kwargs)

        setattr(kkt, name, counted)


@pytest.fixture(scope="module")
def solved():
    """Each case solved once with its backend's calls counted."""
    out = {}
    for case in CASES:
        solver = _solver(case)
        calls = dict.fromkeys(KKT_CALLS, 0)
        _wrap_kkt(solver.kkt, calls)
        res = solver.solve()
        assert res.status == "first_order", case
        # no restoration: every factorization is a direction's
        assert not any("ipm.restore" in p for p in res.spans), case
        out[case] = (res, calls)
    return out


def _host_syncs(res):
    return sum(t["calls"] for p, t in res.spans.items()
               if p.endswith("ipm.host_sync"))


@pytest.mark.parametrize("case", list(CASES))
def test_refine_rounds_are_the_loops_rounds(solved, case):
    res, calls = solved[case]
    # each direction multiplies once before its loop, each round once more
    assert res.counts["kkt.refine_rounds"] == calls["matvec"] - calls["factor"]


@pytest.mark.parametrize("case", list(CASES))
def test_soc_trials_are_the_corrections_tried(solved, case):
    res, calls = solved[case]
    rounds = res.counts["kkt.refine_rounds"]
    assert res.counts["ipm.soc_trials"] == \
        calls["solve"] - calls["factor"] - rounds
    # the correction's solve is the one the line search spans
    soc_solves = sum(t["calls"] for p, t in res.spans.items()
                     if p.endswith("ipm.line_search/kkt.solve"))
    assert res.counts["ipm.soc_trials"] == soc_solves


def test_the_cases_exercise_both_counters(solved):
    """Not vacuous: opf tries a correction and quad refines."""
    assert solved["opf-10"][0].counts["ipm.soc_trials"] > 0
    assert solved["quad-12"][0].counts["kkt.refine_rounds"] > 0


def test_both_counters_read_zero_when_nothing_happened():
    model, _ = transcribe(tmodels.hovercraft(num_supports=11), device="cpu")
    res = IpmSolver(model, print_level=0, linear_solver="auto").solve()
    assert res.status == "first_order"
    assert res.counts["ipm.soc_trials"] == 0
    assert res.counts["kkt.refine_rounds"] == 0


@pytest.mark.parametrize("case", list(CASES))
def test_counting_adds_no_host_read(solved, case, monkeypatch):
    res, _ = solved[case]
    monkeypatch.setattr(tipm, "count", lambda name, k=1: None)
    bare = _solver(case).solve()
    assert "ipm.soc_trials" not in bare.counts
    assert "kkt.refine_rounds" not in bare.counts
    assert bare.iter == res.iter
    assert _host_syncs(bare) == _host_syncs(res)


@pytest.mark.parametrize("case", list(CASES))
def test_the_step_shares_add_up_to_the_step(solved, case):
    res, _ = solved[case]
    step = res.spans["ipm.solve/ipm.step"]
    shares = program_spans.step_shares_ms(res)
    per_step = 1e3 * step["s"] / res.iter
    assert abs(sum(shares.values()) - per_step) <= 1e-3 / res.iter
