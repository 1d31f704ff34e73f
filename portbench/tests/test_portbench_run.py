"""A run's last line, the entry's refusal without a card, and what a run
loads."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness, registry
from portbench.tests.conftest import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_has_the_contracts_keys(traced):
    cell = tiny_cell("quad-16000.resolve", trace=traced)
    result, notes = harness.run(cell, 2 ** 31 + 3, 0.0, traced,
                                device="cpu")
    assert list(result) == KEYS + (["breakdown"] if traced else []) + \
        ["checks"]
    assert result["correct"] is True
    # a traced window runs on past its two traced requests
    assert result["attempted"] == (3 if traced else 1)
    assert result["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(result["device"])
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"}, name
    names = {m["name"] for m in cell["metrics"]}
    assert set(result["metrics"]) <= names
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    if traced:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0
        # device numbers never come from a CPU run
        assert "device.idle_pct.resolve" not in result["metrics"]
        assert "k1_roofline" not in result["metrics"]
    json.dumps(result)


def test_the_entry_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "quad-16000.resolve", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=registry.ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_the_entry_fails_where_only_the_benchmark_is(tmp_path):
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; torch.cuda.is_available = lambda: True;"
         "torch.cuda.device_count = lambda: 1;"
         "from portbench import run;"
         "sys.exit(run.main(['--workload', 'quad-16000.resolve',"
         " '--seed', '1', '--seconds', '1', '--trace', '0']))"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench import harness, run\n"
        "from portbench.tests.conftest import OPF_SEED, tiny_cell\n"
        "harness.run(tiny_cell('opf-16000.resolve'), 5, 0.0, False,"
        " device='cpu')\n"
        "print(json.dumps(run.loaded_forbidden()))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=600).stdout.splitlines()
    assert json.loads(out[-2]) == []
    loaded = set(json.loads(out[-1]))
    assert "infiniteexamodels_jl_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "infiniteexamodels_jl_tpu"}


def test_a_build_request_runs_through_the_harness():
    """The build path and its end-to-end readers, in the cell
    ``quad-16000.build`` as ``BENCHMARK.json`` defines it."""
    cell = tiny_cell("quad-16000.build")
    assert cell["mix"] == registry.mix("build-solve")
    result, notes = harness.run(cell, 2 ** 31 + 7, 0.0, False, device="cpu")
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"build_solve_s", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
