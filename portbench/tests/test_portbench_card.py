"""On the card: a traced run of a small cell reports every per-layer
metric the cell lists, the device's from the profiler (K1 runs only
there; skips without a card).

    python3 -m pytest -o addopts="" -p no:cacheprovider -m cuda \\
        portbench/tests/test_portbench_card.py
"""
import pytest

from portbench import harness
from portbench.tests.conftest import OPF_SEED, tiny_cell

# opf at 64 scenarios is the fewest that take the scenario KKT (65
# blocks of 24 and a border of 6), so that K1 launches; at fewer the
# dense KKT solves them
CASES = [("quad-16000.resolve", 20, 2 ** 31 + 5),
         ("opf-16000.resolve", 64, OPF_SEED)]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,size,seed", CASES)
def test_a_traced_run_reads_the_device(card, workload, size, seed):
    cell = tiny_cell(workload, trace=True, size=size)
    result, notes = harness.run(cell, seed, 0.0, True, device=card)
    assert result["correct"], (result["checks"], notes["requests"])
    metrics = result["metrics"]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
    assert 0 < metrics["device.idle_pct.resolve"]["value"] < 100
    assert 0 < metrics["k1_roofline"]["value"] <= 105
    assert {m["name"] for m in cell["metrics"]} == set(metrics)
    assert notes["memory_above_baseline_bytes"] > 0
