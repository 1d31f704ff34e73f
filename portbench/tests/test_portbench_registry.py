"""Cells, configurations, traffic mixes and metric readers are found by
name from BENCHMARK.json."""
import json
import os

import pytest

from portbench import registry

BENCH = registry.load_benchmark()


def test_every_file_of_every_cell_is_found():
    for w in BENCH["workloads"]:
        cell = registry.cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["mix"]["request"] in ("resolve", "build")
        for m in cell["metrics"]:
            assert callable(registry.reader(m["name"]))


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_its_reader(metric):
    assert callable(registry.reader(metric))


def test_configs_state_their_cut_and_reference():
    for c in BENCH["configs"]:
        path = os.path.join(registry.ROOT, c["file"])
        with open(path) as fh:
            conf = json.load(fh)
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"] == []
        assert conf["assumed"] == []
        assert os.path.exists(os.path.join(
            registry.HERE, "reference", f"{conf['reference']}.py"))
        assert conf["limits"]["not_first_order"] == 0


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in registry.cell_metrics(BENCH, w["name"],
                                                        False)]
        layers = registry.cell_metrics(BENCH, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layers
        assert {m["moves"] for m in layers} <= set(e2e)


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        registry.cell("no-such-cell")
