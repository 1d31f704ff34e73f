"""Whole IPM solves of the port over a 4-rank CPU mesh (gloo), against the
JAX package's single-device and 4-device-mesh solves.

The ranks are spawned once for the file (tests/torch_mesh_ranks.py, suite
"solve"): farmer-16 (its first-stage degree is too low for a border, so
the KKT is the dense fallback), farmer-64 (the aligned scenario KKT, in
f64 and in the "mixed" step set) and quad-24 (the aligned band KKT)
through ``ExaTranscriptionBackend(IpmSolver, mesh=..., linear_solver=
"auto")``, plus a checkpoint resumed across the layouts.  A second launch
of 2 ranks goes through ``parallel.distributed.initialize`` and
``global_mesh``, the entry points a ``torchrun`` script calls."""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.backend import (
    ExaTranscriptionBackend as JBackend)
from infiniteexamodels_jl_tpu.parallel import make_mesh as jmake_mesh
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.transcribe import transcribe
from test_multihost import _FARMER64_OBJ
from torch_mesh_ranks import CHECKPOINT, SOLVES, build, start, wait

SIZE = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's single-device solves and evaluations run on one
    intra-op thread, as its ranks do: their tensors are small, and test
    workers that each keep a pool of spinning OpenMP threads on the same
    cores slow one another several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _single_device(key):
    """The port's single-device solve of a SOLVES case."""
    name, kw, opts = SOLVES[key]
    m = build(name, **kw)
    m.set_transformation_backend(ExaTranscriptionBackend(
        IpmSolver, device="cpu", linear_solver="auto", print_level=0,
        **opts))
    return m.optimize()


def _jax(key, mesh=None):
    name, kw, opts = SOLVES[key]
    m = getattr(jmodels, name)(**kw)
    m.set_transformation_backend(JBackend(JIpmSolver, mesh=mesh,
                                          linear_solver="auto", **opts))
    m.set_silent()
    return m.optimize()


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The 4-rank "solve" suite and the 2-rank "distributed" one, run at
    the same time."""
    tmp = tmp_path_factory.mktemp("sharded_solve")
    # a single-device checkpoint for the ranks to resume
    name, kw, cut = CHECKPOINT
    model, _ = transcribe(build(name, **kw), device="cpu")
    IpmSolver(model, linear_solver="auto", print_level=0).solve(
        checkpoint_path=str(tmp / "single.npz"), checkpoint_every=cut,
        max_iter=cut)
    two = start("distributed", 2, tmp_path_factory.mktemp("distributed"))
    four = start("solve", SIZE, tmp)
    return tmp, wait(four), wait(two)


@pytest.fixture(scope="module")
def solves(launches):
    return launches[:2]


@pytest.fixture(scope="module")
def farmer16_jax():
    """The JAX package's farmer-16, on one device and on a 4-device
    mesh."""
    return _jax("farmer16"), _jax("farmer16", jmake_mesh(SIZE))


def _same_on_every_rank(ranks, key):
    got = ranks[0][key]
    for r in ranks[1:]:
        assert r[key]["digest"] == got["digest"]
        assert r[key]["iter"] == got["iter"]
    return got


def test_farmer16_mesh_solve(solves, farmer16_jax):
    """farmer-16 on 4 ranks ends first_order at the JAX single-device
    objective and at the JAX 4-device mesh solve's (rel 1e-8), with the
    final x bit-identical on every rank and to the port's single-device
    solve (the sharded model's outputs are the unsharded one's)."""
    _, ranks = solves
    got = _same_on_every_rank(ranks, "farmer16")
    assert got["status"] == "first_order"
    ref, jmesh = farmer16_jax
    assert ref.status == jmesh.status == "first_order"
    assert got["objective"] == pytest.approx(ref.objective, rel=1e-8)
    assert got["objective"] == pytest.approx(jmesh.objective, rel=1e-8)
    single = _single_device("farmer16")
    np.testing.assert_array_equal(got["x"], single.solution)
    assert got["iter"] == single.iter


def test_farmer64_scenario_mesh_solve(solves):
    """farmer-64 goes through the aligned ShardedScenarioKKT (16 blocks a
    rank) and ends first_order at the JAX package's record of the same
    problem (tests/test_multihost.py, the host LDL; rel 1e-8), final x
    bit-identical on every rank."""
    _, ranks = solves
    got = _same_on_every_rank(ranks, "farmer64")
    assert (got["kkt"], got["aligned"]) == ("ShardedScenarioKKT", True)
    assert got["status"] == "first_order"
    assert got["objective"] == pytest.approx(_FARMER64_OBJ, rel=1e-8)


def test_farmer64_mixed_mesh_solve(solves):
    """factor_dtype="mixed" on the scenario mesh: first_order within 1e-9
    of the f64 objective, final x bit-identical on every rank."""
    _, ranks = solves
    got = _same_on_every_rank(ranks, "farmer64_mixed")
    f64 = ranks[0]["farmer64"]
    assert (got["kkt"], got["aligned"]) == ("ShardedScenarioKKT", True)
    assert got["status"] == "first_order"
    assert got["objective"] == pytest.approx(f64["objective"], rel=1e-9)


def test_quad24_band_mesh_solve(solves):
    """quad-24 (tol 1e-8) through the aligned ShardedBandKKT ends
    first_order at the port's single-device objective (rel 1e-8), in as
    many iterations, final x bit-identical on every rank."""
    _, ranks = solves
    got = _same_on_every_rank(ranks, "quad24")
    assert (got["kkt"], got["aligned"]) == ("ShardedBandKKT", True)
    assert got["status"] == "first_order"
    single = _single_device("quad24")
    assert single.status == "first_order" and got["iter"] == single.iter
    assert got["objective"] == pytest.approx(single.objective, rel=1e-8)


def test_checkpoint_crosses_layouts(solves):
    """A single-device checkpoint resumes on the mesh, and the mesh's
    checkpoint (written by rank 0) resumes on one device: both end
    first_order next to the uninterrupted single-device solve."""
    tmp, ranks = solves
    name, kw, cut = CHECKPOINT
    model, _ = transcribe(build(name, **kw), device="cpu")
    whole = IpmSolver(model, linear_solver="auto", print_level=0).solve()
    resumed = ranks[0]["resumed"]
    assert resumed["kkt"] == "ShardedBandKKT"
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["resumed"]["x"], resumed["x"])
    back = IpmSolver(model, linear_solver="auto", print_level=0).solve(
        resume_from=str(tmp / "sharded.npz"))
    for res in (resumed, dict(status=back.status, iter=back.iter,
                              x=back.solution)):
        assert res["status"] == "first_order"
        assert abs(res["iter"] - whole.iter) <= 2
        np.testing.assert_allclose(res["x"], whole.solution, rtol=1e-6,
                                   atol=1e-6)


def test_two_rank_launch_through_initialize(launches, farmer16_jax):
    """2 ranks through parallel.distributed.initialize and global_mesh:
    rank 0 solves farmer-16 to the JAX single-device objective."""
    ranks = launches[2]
    got = ranks[0]
    assert got["process_info"] == (0, 2, 1, 2)
    assert ranks[1]["process_info"][0] == 1
    assert got["status"] == "first_order"
    assert ranks[1]["digest"] == got["digest"]
    assert got["objective"] == pytest.approx(farmer16_jax[0].objective,
                                             rel=1e-8)
