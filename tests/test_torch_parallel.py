"""The port's multi-device backends on a 4-rank CPU mesh (gloo), against
the JAX package on a 4-device mesh and the port's single-device backends.

The ranks are spawned once for the whole file (tests/torch_mesh_ranks.py,
suite "parallel"): the aligned scenario KKT on pandemic(10, 16) and the
aligned band KKT on quad-24 (assemble, factor, matvec, solve, the T-layout
round trip, the collectives of one T-layout step), and the sharded model's
evaluations on farmer-80 and hovercraft-101.  Tolerances are the JAX
package's own (tests/test_parallel.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.parallel import make_mesh as jmake_mesh
from infiniteexamodels_jl_tpu.parallel import shard_model as jshard_model
from infiniteexamodels_jl_tpu.solvers.band_shard import (
    ShardedBandKKT as JShardedBandKKT)
from infiniteexamodels_jl_tpu.solvers.scenario_shard import (
    ShardedScenarioKKT as JShardedScenarioKKT)
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch.solvers.block_tridiag import BlockTridiagKKT
from infiniteexamodels_jl_torch.transcribe import transcribe
from torch_mesh_ranks import (KKT_CASES, ROUNDTRIP_SEED, build, kkt_inputs,
                              launch)

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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch("parallel", SIZE, tmp_path_factory.mktemp("parallel"))


def _port_reference(case, nb):
    """The port's single-device BlockTridiagKKT on the same padded model
    (and, for the band, the same padded block grid)."""
    (name, kw), seed, shift, lam_scale = KKT_CASES[case]
    model, _ = transcribe(build(name, **kw), device="cpu", row_pad=SIZE)
    kkt = BlockTridiagKKT(model, nb_round=lambda _: nb)
    shift, lam, d, de, rhs = kkt_inputs(model.nvar, model.ncon, seed, shift,
                                        lam_scale)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    K = kkt.assemble(model.x0 + shift, model.theta, t(lam), 1.0, t(d), t(de))
    fac, ok = kkt.factor(K)
    assert bool(ok) and kkt.nb == nb
    return kkt.matvec(K, t(rhs)).numpy(), kkt.solve(fac, t(rhs)).numpy()


def _jax_sharded(case):
    """The JAX package's aligned backend on a 4-device mesh."""
    (name, kw), seed, shift, lam_scale = KKT_CASES[case]
    model, _ = jtranscribe(getattr(jmodels, name)(**kw), row_pad=SIZE)
    mesh = jmake_mesh(SIZE)
    jshard_model(model, mesh)
    cls = JShardedScenarioKKT if case == "scenario" else JShardedBandKKT
    kkt = cls(model, mesh=mesh)
    assert kkt.aligned
    shift, lam, d, de, rhs = kkt_inputs(model.nvar, model.ncon, seed, shift,
                                        lam_scale)
    x = jnp.asarray(model.x0) + shift
    lam, d, de, rhs = (jnp.asarray(a) for a in (lam, d, de, rhs))
    K = jax.jit(lambda: kkt.assemble(x, model.theta, lam, 1.0, d, de))()
    fac, ok = jax.jit(kkt.factor)(K)
    assert bool(ok)
    return (np.asarray(jax.jit(kkt.matvec)(K, rhs)),
            np.asarray(jax.jit(kkt.solve)(fac, rhs)), kkt.nb)


@pytest.mark.parametrize("case", ["scenario", "band"])
def test_aligned_kkt_matches_jax_and_single_device(ranks, case):
    """Assemble + factor + matvec (rtol 1e-12, atol 1e-12) and solve (rtol
    1e-9, atol 1e-11) of the aligned sharded KKT against the JAX package's
    and against the port's single-device BlockTridiagKKT; the same bytes
    on every rank."""
    got = ranks[0][case]
    assert got["aligned"] and got["tlayout"] and got["ok"]
    assert got["nd"] == SIZE and got["nb_loc"] * SIZE == got["nb"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[case]["matvec"], got["matvec"])
        np.testing.assert_array_equal(r[case]["solve"], got["solve"])
    jmv, jsol, jnb = _jax_sharded(case)
    assert jnb == got["nb"]
    mv, sol = _port_reference(case, got["nb"])
    for ref_mv, ref_sol in ((jmv, jsol), (mv, sol)):
        np.testing.assert_allclose(got["matvec"], ref_mv, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(got["solve"], ref_sol, rtol=1e-9,
                                   atol=1e-11)


@pytest.mark.parametrize("case", ["scenario", "band"])
def test_rank_holds_only_its_blocks(ranks, case):
    """An aligned rank keeps none of the parent's whole-system device
    tables (assembly plans, padding identity, slot permutations), and its
    assembled diagonal blocks are its share of the system's."""
    for r in ranks:
        got = r[case]
        assert got["whole_system_tables"] == []
        bs = got["bs"]
        assert got["block_elements"][0] == got["nb_loc"] * bs * bs


@pytest.mark.parametrize("case", ["scenario", "band"])
def test_tlayout_roundtrip_and_norm(ranks, case):
    """tl_scatter(tl_gather(v)) == v exactly, and tl_norm is the 2-norm."""
    got = ranks[0][case]
    v = np.random.default_rng(ROUNDTRIP_SEED).standard_normal(got["n"])
    np.testing.assert_array_equal(got["roundtrip"], v)
    assert got["tl_norm"] == pytest.approx(float(np.linalg.norm(v)),
                                           rel=1e-12)


def test_scenario_step_communication_is_border_only(ranks):
    """One T-layout step of the scenario KKT (assemble, factor, solve_tl,
    matvec_tl, a refinement round, tl_norm) has no all-gather and no
    collective above mB^2 + mB + 64 elements (< n); the replicated solve
    wrapper adds exactly one all-gather."""
    got = ranks[0]["scenario"]
    mB, n = got["mB"], got["n"]
    cap = mB * mB + mB + 64
    assert cap < n
    kinds = [k for k, _ in got["step_log"]]
    assert "all_gather" not in kinds and "ppermute" not in kinds
    assert kinds.count("psum") >= 4          # C, Schur corner, border rhs
    assert all(el <= cap for _, el in got["step_log"]), got["step_log"]
    assert [k for k, _ in got["wrapper_log"]].count("all_gather") == 1


def test_band_step_communication_is_halo_sized(ranks):
    """One T-layout step of the band KKT: every ring shift is a halo
    (<= 3 bs^2 + bs mB + 64 elements), every all-gather the BCR tail
    (<= 2 bs^2 from each rank: 2 nd bs^2 in all), nothing reduces more
    than mB^2 + mB + 64 elements (< n)."""
    got = ranks[0]["band"]
    bs, mB, n = got["bs"], got["mB"], got["n"]
    caps = {"ppermute": 3 * bs * bs + bs * max(mB, 1) + 64,
            "all_gather": 2 * bs * bs,
            "psum": mB * mB + mB + 64, "psum_scalar": 1}
    assert caps["psum"] < n
    kinds = {k for k, _ in got["step_log"]}
    assert {"ppermute", "all_gather"} <= kinds
    for kind, el in got["step_log"]:
        assert el <= caps[kind], (kind, el)


def test_sharded_evaluations_match_replicated(ranks):
    """farmer-80 (no padding) on 4 ranks: objective, gradient, constraints,
    Jacobian, KKT values and Hessian-vector product equal the unsharded
    model's exactly and the JAX package's within rel 1e-12 / rtol 1e-10;
    every evaluation is one all-gather of the rows' values."""
    m = build("farmer", num_scenarios=80)
    model, _ = transcribe(m, device="cpu")
    jmodel, _ = jtranscribe(jmodels.farmer(num_scenarios=80))
    x = model.x0 + 0.05
    lam = torch.linspace(0.1, 1.0, model.ncon, dtype=torch.float64)
    d = torch.full((model.ncon,), 2.0, dtype=torch.float64)
    v = torch.arange(model.nvar, dtype=torch.float64) / model.nvar
    ref = dict(obj=float(model.obj(x, model.theta)),
               grad=model.grad(x, model.theta).numpy(),
               cons=model.cons(x, model.theta).numpy(),
               jac=model.jac_vals(x, model.theta).numpy(),
               kkt=model.kkt_vals(x, model.theta, lam, 1.5, d).numpy(),
               hvp=model.hvp_lag(x, model.theta, lam, 1.5, v).numpy())
    jx = jnp.asarray(x.numpy())
    jref = dict(obj=float(jmodel.obj(jx, jmodel.theta)),
                grad=np.asarray(jmodel.grad(jx, jmodel.theta)),
                cons=np.asarray(jmodel.cons(jx, jmodel.theta)))
    total_rows = sum(f.n for f in model.con_fams + model.obj_fams)
    for r in ranks:
        got = r["evals"]["farmer80"]
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got["obj"] == pytest.approx(jref["obj"], rel=1e-12)
        np.testing.assert_allclose(got["grad"], jref["grad"], rtol=1e-10)
        np.testing.assert_allclose(got["cons"], jref["cons"], rtol=1e-10)
        assert [k for k, _ in got["log"]] == ["all_gather"] * 6
        assert 0.5 < got["fraction"] < 1.0        # one family kept whole
        assert got["local_rows"] < total_rows


def test_padded_shards_fully_and_evaluates_as_unpadded(ranks):
    """hovercraft-101 with row_pad = 4: every family is shared out
    (sharded_fraction 1, as the JAX package's) and the padded, sharded
    model evaluates exactly as the unpadded one."""
    model, _ = transcribe(build("hovercraft", num_supports=101),
                          device="cpu")
    x = model.x0 + 0.05
    lam = torch.linspace(0.1, 1.0, model.ncon, dtype=torch.float64)
    d = torch.full((model.ncon,), 2.0, dtype=torch.float64)
    v = torch.arange(model.nvar, dtype=torch.float64) / model.nvar
    jmodel, _ = jtranscribe(jmodels.hovercraft(num_supports=101),
                            row_pad=SIZE)
    mesh = jmake_mesh(SIZE)
    jshard_model(jmodel, mesh)
    from infiniteexamodels_jl_tpu.parallel import sharded_fraction
    assert sharded_fraction(jmodel, mesh) == pytest.approx(1.0)
    local = [r["evals"]["hovercraft101"]["local_rows"] for r in ranks]
    assert len(set(local)) == 1                 # equal shares
    for r in ranks:
        got = r["evals"]["hovercraft101"]
        assert got["fraction"] == pytest.approx(1.0)
        assert got["obj"] == float(model.obj(x, model.theta))
        np.testing.assert_array_equal(got["grad"],
                                      model.grad(x, model.theta).numpy())
        np.testing.assert_array_equal(got["cons"],
                                      model.cons(x, model.theta).numpy())
        np.testing.assert_array_equal(
            got["jac"], model.jac_vals(x, model.theta).numpy())
        np.testing.assert_array_equal(
            got["kkt"], model.kkt_vals(x, model.theta, lam, 1.5, d).numpy())
        np.testing.assert_array_equal(
            got["hvp"], model.hvp_lag(x, model.theta, lam, 1.5, v).numpy())


def test_mesh_defaults_to_the_card(ranks):
    """make_mesh() without a device means this rank's CUDA card, and on a
    host without one it raises instead of making a CPU mesh."""
    for r in ranks:
        assert "torch.cuda.is_available() is False" in r["default_device"]
