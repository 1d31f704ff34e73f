"""The plain reference accepts the program's answers on tiny CPU solves
and rejects perturbed ones; it imports nothing of the program."""
import ast
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import drive, generate, judge, registry
from portbench.tests.conftest import OPF_SEED, tiny_cell

FORBIDDEN = {"infiniteexamodels_jl_torch", "infiniteexamodels_jl_tpu",
             "jax", "jaxlib", "flax"}
SEED = OPF_SEED


@pytest.fixture(scope="module", params=["quad-16000.resolve",
                                        "opf-16000.resolve"])
def solved(request):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = tiny_cell(request.param)
        config = cell["config"]
        system = drive.System(config, torch.device("cpu"), SEED)
        system.build()
        req = generate.request(cell["mix"], 0)
        _, answer = system.request(req["kind"], req["set_parameters"])
    finally:
        torch.set_num_threads(n)
    return config, answer


def judged(config, answer):
    values = judge.worst([judge.readings(config, answer, SEED)],
                         [answer["status"]])
    return judge.compare(config, values)


def test_reference_accepts_the_programs_answer(solved):
    ok, checks = judged(*solved)
    assert ok, checks


def test_reference_rejects_a_moved_primal_point(solved):
    config, answer = solved
    bad = copy.deepcopy(answer)
    name = sorted(k for k, v in bad["values"].items() if np.size(v) > 1)[0]
    bad["values"][name] = np.array(bad["values"][name], dtype=np.float64)
    bad["values"][name][1] += 1e-3
    ok, checks = judged(config, bad)
    assert not ok and checks["primal_inf"]["value"] > \
        checks["primal_inf"]["limit"]


def test_reference_rejects_wrong_duals(solved):
    """Flipped duals read far off; where the configuration compares
    ``dual_inf`` (its float32 control moves it), the run is wrong."""
    config, answer = solved
    bad = copy.deepcopy(answer)
    i = max(range(len(bad["duals"])),
            key=lambda k: float(np.abs(bad["duals"][k]).max()))
    bad["duals"][i] = -np.asarray(bad["duals"][i])
    sound = judge.readings(config, answer, SEED)["dual_inf"]
    assert judge.readings(config, bad, SEED)["dual_inf"] > 1e3 * sound
    if "dual_inf" in config["limits"]:
        assert not judged(config, bad)[0]


def test_reference_rejects_a_wrong_objective(solved):
    config, answer = solved
    bad = dict(answer, objective=answer["objective"] * (1 + 1e-6))
    ok, checks = judged(config, bad)
    assert not ok and checks["obj_rel"]["value"] > \
        checks["obj_rel"]["limit"]


def test_reference_rejects_a_status_that_is_not_first_order(solved):
    config, answer = solved
    values = judge.worst([judge.readings(config, answer, SEED)],
                         ["max_iter"])
    ok, checks = judge.compare(config, values)
    assert not ok and checks["not_first_order"]["value"] == 1


def test_an_answer_the_reference_cannot_read_is_wrong(solved):
    config, answer = solved
    bad = copy.deepcopy(answer)
    bad["duals"] = bad["duals"][:-1]
    if config["reference"] == "quad":
        bad["derivatives"] = {}
    ok, _ = judged(config, bad)
    assert not ok


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_sources_import_nothing_of_the_program():
    ref = os.path.join(registry.HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            assert not set(_imports(os.path.join(ref, f))) & FORBIDDEN, f


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, portbench.reference.quad, portbench.reference.opf;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    loaded = set(eval(out))
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
