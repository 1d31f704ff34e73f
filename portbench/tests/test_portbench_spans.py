"""The readers of the program's spans and counters on a traced tiny run."""
import math

from portbench import harness
from portbench.tests.conftest import tiny_cell

SPAN_METRICS = [
    "ad.kkt_vals_step_ms", "ad.sweeps_step_ms", "kkt.assemble_self_step_ms",
    "kkt.factor_step_ms", "kkt.solve_step_ms", "ipm.self_step_ms",
    "ipm.host_sync_step_ms", "ipm.host_syncs_per_step",
    "ipm.ls_trials_per_step", "kkt.regularizations_per_solve"]
SHARES = SPAN_METRICS[1:7]


def test_a_traced_run_reports_the_span_metrics():
    cell = tiny_cell("quad-16000.resolve", trace=True)
    assert set(SPAN_METRICS) <= {m["name"] for m in cell["metrics"]}
    result, notes = harness.run(cell, 2 ** 31 + 17, 0.0, True,
                                device="cpu")
    assert result["correct"] is True
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for name in SPAN_METRICS:
        assert name in got and math.isfinite(got[name]), name
    assert 0 < got["ad.kkt_vals_step_ms"] <= got["ad.sweeps_step_ms"]
    assert sum(got[k] for k in SHARES) > 0
    assert got["ipm.host_syncs_per_step"] >= 1
    assert got["ipm.ls_trials_per_step"] >= 1
