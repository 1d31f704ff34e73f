"""The cell ``opf-16000.resolve``: found by name from ``BENCHMARK.json``
with the metrics it reports, a tiny run of it on the CPU judged correct,
the readers of the IPM's counters, and on the card a traced run that reads
every metric the cell lists (skips without a card).

    python3 -m pytest -o addopts="" -p no:cacheprovider -m cuda \\
        portbench/tests/test_portbench_opf_cell.py
"""
import copy
import math
from types import SimpleNamespace

import pytest

from portbench import harness, registry
from portbench.tests.conftest import OPF_SEED, SIZES, TINY_LIMITS

WORKLOAD = "opf-16000.resolve"
SHARED = [
    "ipm.iters_per_solve", "ipm.step_ms", "ipm.self_step_ms",
    "ipm.host_sync_step_ms", "ipm.host_syncs_per_step",
    "ipm.ls_trials_per_step", "ad.sweeps_step_ms", "ad.kkt_vals_step_ms",
    "ad.graph_replay_share", "kkt.assemble_self_step_ms",
    "kkt.factor_step_ms", "kkt.solve_step_ms",
    "kkt.regularizations_per_solve", "k1_roofline",
    "device.idle_pct.resolve", "kkt.solve_graph_replay_share",
    "ipm.graph_replay_share"]
COUNTERS = {"kkt.refine_rounds_per_step": "kkt.refine_rounds",
            "ipm.soc_per_step": "ipm.soc_trials"}
# 64 scenarios are the fewest that take the scenario KKT (65 blocks of 24
# and a border of 6), so that K1 launches; at fewer the dense KKT solves
CARD_SIZE = 64


def opf_cell(trace, size=None):
    """The cell as ``BENCHMARK.json`` defines it, at 10 scenarios or at
    ``size``, held to the tiny sizes' limits."""
    cell = copy.deepcopy(registry.cell(WORKLOAD, trace=trace))
    config = cell["config"]
    n = size or SIZES[config["name"]]
    config["kwargs"]["num_supports"] = n
    config["inputs"]["num_supports"] = n
    config["limits"].update(TINY_LIMITS[config["name"]])
    return cell


def test_the_cell_is_found_with_its_metrics():
    cell = registry.cell(WORKLOAD)
    assert cell["workload"]["config"] == "opf-16000"
    assert cell["workload"]["traffic"] == "resolve"
    assert cell["workload"]["chips"] == 1
    assert cell["config"]["kwargs"]["num_supports"] == 16000
    assert cell["config"]["reduced"] == cell["config"]["assumed"] == []
    assert cell["mix"]["request"] == "resolve"
    assert cell["mix"]["set_parameters"] is False
    assert [m["name"] for m in cell["metrics"]] == ["setup_s", "solve_s"]
    layers = registry.cell(WORKLOAD, trace=True)["metrics"]
    assert sorted(m["name"] for m in layers) == sorted(SHARED + list(COUNTERS))
    assert {m["moves"] for m in layers} == {"solve_s"}


@pytest.fixture(scope="module")
def cpu_runs():
    """The tiny cell run once untraced and once traced on the CPU."""
    return {traced: harness.run(opf_cell(traced), OPF_SEED, 0.0, traced,
                                device="cpu")[0]
            for traced in (False, True)}


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_run_is_correct(cpu_runs, traced):
    result = cpu_runs[traced]
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("metric", list(COUNTERS))
def test_the_counter_readers_read_the_cpu_run(cpu_runs, metric):
    value = cpu_runs[True]["metrics"][metric]["value"]
    assert math.isfinite(value) and value >= 0


def _run_with(counts, iters=16):
    res = SimpleNamespace(iter=iters, spans={"ipm.solve": {}},
                          counts=counts)
    system = SimpleNamespace(solver=lambda: SimpleNamespace(results=res))
    return SimpleNamespace(system=system)


@pytest.mark.parametrize("metric,counter", list(COUNTERS.items()))
def test_the_counter_readers_divide_by_the_iterations(metric, counter):
    read = registry.reader(metric)
    assert read(_run_with({counter: 24})) == 1.5
    assert read(_run_with({counter: 0})) == 0
    # an older program: spans without the counter, or no spans at all
    assert read(_run_with({"kkt.regularizations": 6})) is None
    no_spans = _run_with({counter: 24})
    no_spans.system.solver().results.spans = {}
    assert read(no_spans) is None


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_every_metric(card):
    cell = opf_cell(True, size=CARD_SIZE)
    result, notes = harness.run(cell, OPF_SEED, 0.0, True, device=card)
    assert result["correct"], (result["checks"], notes["requests"])
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(metrics) == set(SHARED + list(COUNTERS))
    assert 0 < metrics["k1_roofline"] <= 105
    assert 0 < metrics["device.idle_pct.resolve"] < 100
    assert metrics["ad.graph_replay_share"] == 1.0
