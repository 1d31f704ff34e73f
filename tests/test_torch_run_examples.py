"""The port's examples harness (``tools/run_examples.py``) and the
profile tool's model table on the CPU: the harness runs every case it is
given in the reference harness's line format with the KKT and K1's
launches per factorization beside it, and its seven cases and options are
examples/run_examples.py's; ``tools/profile.py`` builds every family."""
import pathlib
import re
import sys

import pytest

from infiniteexamodels_jl_torch import models as M
from infiniteexamodels_jl_torch.tools import profile, run_examples


def test_cases_and_options_are_the_reference_harness():
    examples = str(pathlib.Path(__file__).resolve().parent.parent
                   / "examples")
    sys.path.insert(0, examples)
    try:
        import run_examples as ref
    finally:
        sys.path.remove(examples)
    assert [n for n, _ in run_examples.CASES] == [n for n, _ in ref.CASES]
    assert run_examples.OPTIONS == dict(linear_solver="auto", print_level=0,
                                        tol=1e-6, max_iter=600)


def test_lines_in_the_reference_format(capsys, monkeypatch):
    monkeypatch.setattr(run_examples, "CASES", [
        ("hovercraft", lambda: M.hovercraft(num_supports=41)),
        ("farmer", lambda: M.farmer(num_scenarios=16)),
    ])
    assert run_examples.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    head = (r"^(\w+)\s+(\w+)\s+iters=\s*(\d+) obj=\s?(\S+) "
            r"pf=(\S+) \[(\S+)s\] ")
    band = re.compile(head + r"kkt=(\w+) (\d+)x(\d+) border=(\d+) "
                      r"k1/factorization=- \(structure (\d+)\)$")
    dense = re.compile(head + r"kkt=DenseKKT$")
    hover, farmer = band.match(lines[0]).groups(), dense.match(lines[1])
    assert hover[:2] == ("hovercraft", "first_order")
    assert float(hover[3]) == pytest.approx(0.04245763849025232, abs=1e-6)
    # 27 band blocks of 16: 5 BCR levels and the root (K1 counts only on
    # the card: "-" here)
    assert hover[6:] == ("band", "27", "16", "0", "6")
    # farmer-16 is small enough for the dense KKT
    assert farmer.groups()[:2] == ("farmer", "first_order")


@pytest.mark.parametrize("model,size", [
    ("quad", "12"), ("opf", "10"), ("hovercraft", "41"), ("kinetics", "30"),
    ("design_3node", "32"), ("pandemic", "25,4")])
def test_profile_builds_every_family(model, size):
    m = profile.MODELS[model](size, False)
    assert m.infinite_vars or m.finite_vars
    cert = profile.MODELS["pandemic"]("25,4", True)
    assert any(v.name == "v_imax" for v in cert.infinite_vars)
