"""The seeded traffic is deterministic."""
import pytest

from portbench import generate, registry

MIXES = ["resolve-tracking", "resolve", "build-solve"]


@pytest.mark.parametrize("name,kind,sets", [
    ("resolve-tracking", "resolve", True),
    ("resolve", "resolve", False),
    ("build-solve", "build", False),
])
def test_every_request_of_a_mix_is_the_same_work(name, kind, sets):
    stream = generate.requests(registry.mix(name))
    reqs = [next(stream) for _ in range(5)]
    assert [r["index"] for r in reqs] == list(range(5))
    assert {(r["kind"], r["set_parameters"]) for r in reqs} == {(kind, sets)}


def test_the_warm_up_is_the_mixs_own_request():
    for name in MIXES:
        mix = registry.mix(name)
        warm = generate.warmup(mix)
        assert {k: v for k, v in warm.items() if k != "index"} == \
            {k: v for k, v in generate.request(mix, 3).items()
             if k != "index"}


def test_a_request_depends_on_its_index_only():
    mix = registry.mix("resolve-tracking")
    stream = generate.requests(mix, start=2)
    assert [next(stream) for _ in range(2)] == \
        [generate.request(mix, 2), generate.request(mix, 3)]


def test_the_seed_draws_the_scenarios_and_the_published_data_stays():
    from portbench import judge

    opf = registry.config("opf-16000")
    quad = registry.cell("quad-16000.resolve")["config"]
    for seed in (-7, 2 ** 40 + 3):
        assert judge.reference_inputs(opf, seed)["seed"] == seed
        assert judge.reference_inputs(quad, seed)["tracking"] == \
            quad["parameter_functions"]
    assert "model_seed" not in opf


def test_opf_scenarios_differ_by_seed_and_repeat_within_one():
    from portbench.reference import opf

    net = opf.network("pglib_opf_case3_lmbd.m")
    big = 2 ** 31 + 12345
    a, b = opf.scenarios(net, big, 8), opf.scenarios(net, big, 8)
    assert (a == b).all()
    assert not (a == opf.scenarios(net, big + 1, 8)).all()


def test_every_cells_mix_is_found_by_name():
    for w in registry.load_benchmark()["workloads"]:
        assert registry.cell(w["name"])["mix"] == registry.mix(w["traffic"])
