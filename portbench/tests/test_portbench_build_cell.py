"""The cell ``quad-16000.build``: found by name from ``BENCHMARK.json``
with the metrics it reports, a tiny traced run of it on the CPU judged
correct with every reader of the host's numbers reading, the copy of the
last build's result that the readers take, which holds no tensor and no
model, the re-solve cells' readers left on the live solver, and on the
card a traced run that reads every metric the cell lists (skips without a
card).

    python3 -m pytest -o addopts="" -p no:cacheprovider -m cuda \\
        portbench/tests/test_portbench_build_cell.py
"""
import gc
import math
import weakref
from types import SimpleNamespace

import pytest
import torch

from portbench import drive, harness, program_spans, registry
from portbench.tests.conftest import tiny_cell

WORKLOAD = "quad-16000.build"
LAYERS = ["ipm.iters_per_solve.build", "transcribe_s", "solver_setup_s",
          "ipm.cold_solve_s", "graphs.captures_per_solve",
          "device.idle_pct.build"]
DEVICE = {"device.idle_pct.build"}
SEED = 2 ** 31 + 23


def test_the_cell_is_found_with_its_metrics():
    cell = registry.cell(WORKLOAD)
    assert cell["workload"]["config"] == "quad-16000"
    assert cell["workload"]["traffic"] == "build-solve"
    assert cell["workload"]["chips"] == 1
    assert cell["config"]["kwargs"]["num_supports"] == 16000
    assert cell["config"]["reduced"] == cell["config"]["assumed"] == []
    assert cell["mix"]["request"] == "build"
    assert cell["mix"]["set_parameters"] is False
    assert [m["name"] for m in cell["metrics"]] == ["setup_s",
                                                    "build_solve_s"]
    layers = registry.cell(WORKLOAD, trace=True)["metrics"]
    assert sorted(m["name"] for m in layers) == sorted(LAYERS)
    assert {m["moves"] for m in layers} == {"build_solve_s"}


def test_a_tiny_traced_run_is_correct_and_every_reader_reads():
    cell = tiny_cell(WORKLOAD, trace=True)
    result, notes = harness.run(cell, SEED, 0.0, True, device="cpu")
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0
    got = {k: v["value"] for k, v in result["metrics"].items()}
    # device numbers never come from a CPU run
    assert set(got) == set(LAYERS) - DEVICE
    assert all(math.isfinite(v) for v in got.values())
    assert got["graphs.captures_per_solve"] == 0
    assert got["ipm.cold_solve_s"] > 0
    assert got["transcribe_s"] > 0
    assert got["ipm.iters_per_solve.build"] == \
        sum(r["iter"] for r in notes["requests"]) / len(notes["requests"])


def _tensors(obj):
    """Every tensor reachable from ``obj`` through containers and
    attributes."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    if hasattr(obj, "__dict__"):
        return _tensors(vars(obj))
    return []


def test_the_kept_result_holds_no_tensor_and_no_model():
    cell = tiny_cell(WORKLOAD)
    system = drive.System(cell["config"], torch.device("cpu"), SEED)
    made = []
    new_model = system.new_model

    def tracked():
        model = new_model()
        made.append(weakref.ref(model))
        return model

    system.new_model = tracked
    rec, _ = system.request("build")
    kept = system.last_build
    assert set(vars(kept)) == {"iter", "spans", "counts"}
    assert kept.iter == rec["iter"] > 0
    assert "ipm.step" in {p.split("/")[-1] for p in kept.spans}
    assert _tensors(kept) == []
    assert system.solver() is None
    gc.collect()
    assert made[0]() is None
    run = SimpleNamespace(system=system)
    assert program_spans.last_result(run) is kept


def test_the_resolve_cells_read_the_live_solver():
    cell = tiny_cell("quad-16000.resolve")
    system = drive.System(cell["config"], torch.device("cpu"), SEED)
    system.build()
    system.request("resolve", True)
    run = SimpleNamespace(system=system)
    assert system.last_build is None
    assert program_spans.last_result(run) is system.solver().results
    # a build request beside the kept model leaves the readers on it
    system.request("build")
    assert system.last_build is not None
    assert program_spans.last_result(run) is system.solver().results


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_every_metric(card):
    cell = tiny_cell(WORKLOAD, trace=True)
    result, notes = harness.run(cell, SEED, 0.0, True, device=card)
    assert result["correct"], (result["checks"], notes["requests"])
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(metrics) == set(LAYERS)
    assert 0 < metrics["device.idle_pct.build"] < 100
    # every graph of the new model is captured in its first solve
    assert metrics["graphs.captures_per_solve"] > 0
