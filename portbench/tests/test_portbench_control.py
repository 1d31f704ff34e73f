"""The control and the faults a cell can have come out not correct.

The control is the program's answer rounded to float32 (the best a float32
computation could hand back); each fault of ``portbench.faults`` is
planted in the program underneath a whole run on the CPU (the look for a
card skipped).
"""
import pytest

from portbench import control, faults, harness, judge
from portbench.tests.conftest import OPF_SEED, tiny_cell

SEED = OPF_SEED


@pytest.mark.parametrize("workload", ["quad-16000.resolve",
                                      "opf-16000.resolve",
                                      "quad-16000.build"])
def test_the_float32_control_fails_and_the_program_passes(workload):
    cell = tiny_cell(workload)
    config = cell["config"]
    (line,) = control.readings(cell, [SEED], "cpu")
    assert judge.compare(config, judge.worst([line["sound"]],
                                             [line["status"]]))[0]
    ok, checks = judge.compare(config, judge.worst([line["f32"]],
                                                   [line["status"]]))
    assert not ok, checks
    assert any(line["f32"][k] > 100 * max(line["sound"][k], 1e-16)
               for k in config["limits"] if k != "not_first_order")


def _run(workload, fault):
    with faults.FAULTS[fault]():
        result, _ = harness.run(tiny_cell(workload), SEED, 0.0, False,
                                device="cpu")
    return result


@pytest.mark.parametrize("workload,fault", [
    ("quad-16000.resolve", "state_unchanged"),
    ("quad-16000.resolve", "answer_altered"),
    ("quad-16000.resolve", "half_the_batch"),
    ("opf-16000.resolve", "half_the_batch"),
    ("quad-16000.resolve", "jacobian_scaled"),
    ("quad-16000.build", "state_unchanged"),
    ("quad-16000.build", "answer_altered"),
    ("quad-16000.build", "half_the_batch"),
    ("quad-16000.build", "jacobian_scaled"),
])
def test_a_planted_fault_is_not_correct(workload, fault):
    result = _run(workload, fault)
    assert result["correct"] is False, result["checks"]


def test_a_wrong_jacobian_is_caught_by_the_lagrangian_alone():
    """A Jacobian a thousandth off leaves the right point and objective
    with wrong duals: only ``dual_inf`` sees it."""
    checks = _run("quad-16000.resolve", "jacobian_scaled")["checks"]
    failed = {k for k, c in checks.items() if c["value"] > c["limit"]}
    assert failed == {"dual_inf"}, checks
