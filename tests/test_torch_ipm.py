"""The PyTorch port's IPM against the JAX package's on the CPU: quad-12
through the band KKT at the oracle with the JAX iteration count, one port
step from every carried-across JAX state, hovercraft-41 with the dense KKT,
and hot parameter updates without a rebuild."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver
from infiniteexamodels_jl_tpu.solvers.ipm import RUNNING as JRUNNING
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.interop import state_from_numpy, state_to_numpy
from infiniteexamodels_jl_torch.modeling import InfiniteModel, integral
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.solvers.block_tridiag import BlockTridiagKKT
from infiniteexamodels_jl_torch.solvers.ipm import IpmState
from infiniteexamodels_jl_torch.transcribe import transcribe as ttranscribe

QUAD12 = 574.5678886441765          # tests/test_models.py ORACLES
HOVERCRAFT41 = 0.04245763849025232


@pytest.fixture(scope="module")
def jax_quad12_states():
    """The JAX CPU solve of quad-12 (band KKT), one state per iteration,
    driven exactly as its host loop drives it one step at a time, and the
    JAX restoration phase run from the initial state."""
    jm, _ = jtranscribe(jmodels.quad(num_supports=12))
    js = JIpmSolver(jm, linear_solver="auto", print_level=0)
    consts = dict(js._compute_consts(jm.theta, jm))
    consts["fam"] = jm.fam_tables()
    consts["jac_rows"] = jm.jac_rows
    consts["jac_cols"] = jm.jac_cols
    y0s = jm.y0 * jm.sense * consts["sf"] / consts["sc"]
    st = js._init_jit(jm.x0, y0s, consts)
    states = [{k: np.array(v) for k, v in st._asdict().items()}]
    # the feasibility restoration phase entered from the initial point
    restored = {k: np.array(v) for k, v in
                jax.jit(js._restore)(st, consts)._asdict().items()}
    while int(st.status) == JRUNNING and int(st.iter) < 100:
        st = js._step_jit(st, consts)      # donates st: copy out first
        states.append({k: np.array(v) for k, v in st._asdict().items()})
    return states, restored


def test_quad12_band_oracle_and_jax_iterations(jax_quad12_states):
    final = jax_quad12_states[0][-1]
    assert int(final["status"]) == 1                     # first_order
    m = tmodels.quad(num_supports=12)
    m.set_transformation_backend(
        ExaTranscriptionBackend(IpmSolver, device="cpu",
                                linear_solver="auto"))
    m.set_silent()
    res = m.optimize()
    assert type(m.backend.solver.kkt) is BlockTridiagKKT
    assert m.backend.solver.kkt.mode == "band"
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(QUAD12, abs=1e-6)
    assert res.iter == int(final["iter"])
    for v in m.infinite_vars[:9]:
        assert np.asarray(m.value(v))[0] == pytest.approx(0.0, abs=1e-6)


# fields that depend on the step direction: the condensed KKT at real
# iterates is ill-conditioned (1/delta_c ~ 1e8 on the lifted equalities),
# so its solution is determined only to ~cond*eps.  They are held to the
# spread between the port's own two exact factorization routes (band and
# dense) at the same state, times 10, floored at 1e-9.
DIRECTION_FIELDS = ("x", "s", "y", "zl", "zu", "log_alpha_z")


def _normwise(a, b):
    fin = np.isfinite(b)
    assert np.array_equal(fin, np.isfinite(a))
    if not fin.any():
        return 0.0
    scale = np.abs(b[fin]).max()
    diff = np.abs(a[fin] - b[fin]).max()
    return diff / scale if scale > 0 else diff


def test_one_step_from_every_jax_state(jax_quad12_states):
    states = jax_quad12_states[0]
    tm, _ = ttranscribe(tmodels.quad(num_supports=12), device="cpu")
    band = IpmSolver(tm, linear_solver="auto", print_level=0)
    dense = IpmSolver(tm, linear_solver="dense", print_level=0)
    consts = band._compute_consts(tm.theta, tm)
    for k in range(len(states) - 1):
        st = state_from_numpy(states[k], "cpu")
        got = state_to_numpy(band._step(st, consts))
        other = state_to_numpy(dense._step(st, consts))
        want = states[k + 1]
        assert list(got) == list(IpmState._fields)
        for name in IpmState._fields:
            a, b = got[name], want[name]
            assert a.dtype == b.dtype, (k, name)
            if a.dtype.kind == "i":
                assert np.array_equal(a, b), (k, name)
            elif name in DIRECTION_FIELDS:
                spread = _normwise(other[name], b)
                assert _normwise(a, b) <= max(1e-9, 10 * spread), \
                    (k, name, _normwise(a, b), spread)
            elif name == "log_rr":
                # a refinement residual at the round-off floor: compared
                # only down to the refinement target (refine_tol)
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
            else:
                # rtol 1e-9 against the field's largest finite entry, with
                # an absolute floor for values that are themselves
                # round-off (inf_pr ~ 1e-15 at convergence)
                assert _normwise(a, b) <= 1e-9 or \
                    np.abs(a - b)[np.isfinite(b)].max() <= 1e-14, \
                    (k, name, _normwise(a, b))


def test_restoration_phase_matches_jax(jax_quad12_states):
    states, restored = jax_quad12_states
    tm, _ = ttranscribe(tmodels.quad(num_supports=12), device="cpu")
    ts = IpmSolver(tm, linear_solver="auto", print_level=0)
    consts = ts._compute_consts(tm.theta, tm)
    got = state_to_numpy(ts._restore(state_from_numpy(states[0], "cpu"),
                                     consts))
    for name in IpmState._fields:
        assert got[name].dtype == restored[name].dtype, name
        assert _normwise(got[name].astype(float),
                         restored[name].astype(float)) <= 1e-9, name


def test_hovercraft41_dense_oracle():
    m = tmodels.hovercraft(num_supports=41)
    m.set_transformation_backend(ExaTranscriptionBackend(IpmSolver,
                                                         device="cpu"))
    m.set_silent()
    res = m.optimize()
    assert res.status == "first_order"
    assert m.objective_value() == pytest.approx(HOVERCRAFT41, abs=1e-6)


def test_hot_parameter_update_resolve():
    """test_solve_parity.py's parameter-update oracles, through the port:
    the second solve reuses the transcription and the solver."""
    m = InfiniteModel(ExaTranscriptionBackend(IpmSolver, device="cpu"))
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    p1 = m.finite_parameter("p1", 100.0)
    p2 = m.finite_parameter("p2", 1.0)
    x = [m.variable(f"x{i}", deps=(t,)) for i in range(2)]
    m.minimize(p1 * integral((x[1] - x[0]**2)**2, t)
               + integral((p2 - x[0])**2, t))
    for i, ub in enumerate([0.5, 3.0]):
        m.constraint(x[i] <= ub)
    m.constraint(x[0] * x[1] >= 1.0)
    m.constraint(x[0] + x[1]**2 >= 0.0)
    m.set_silent()
    m.optimize()
    assert m.objective_value() == pytest.approx(306.4999755050365, abs=1e-6)
    model, solver = m.backend.model, m.backend.solver
    m.set_parameter_value(p1, 90.0)
    m.set_parameter_value(p2, 1.3)
    assert m.transformation_backend_ready()
    m.optimize()
    assert m.backend.model is model and m.backend.solver is solver
    assert m.objective_value() == pytest.approx(276.26497794903645, abs=1e-6)
    assert m.value(p1) == 90.0 and m.value(p2) == 1.3
    # warm start from the last solution re-certifies in fewer iterations
    it_cold = m.backend.results.iter
    m.warmstart_backend_start_values()
    res = m.optimize()
    assert res.status == "first_order" and res.iter <= it_cold
    assert m.objective_value() == pytest.approx(276.26497794903645, abs=1e-6)


@pytest.mark.parametrize("option", [
    dict(factor_dtype="mixed"), dict(ray_damping=True),
    dict(prox_dual_kappa=1.0), dict(recalc_y=True),
    dict(recalc_y_stall=True), dict(dual_init="lsq"),
    dict(linear_solver="ldl_cpp"), dict(barrier="adaptive"),
])
def test_options_not_ported_raise(option):
    tm, _ = ttranscribe(tmodels.hovercraft(num_supports=11), device="cpu")
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        IpmSolver(tm, **option)


def test_jax_state_round_trip():
    st = {k: np.zeros(3) for k in IpmState._fields}
    st["iter"] = np.asarray(4, np.int32)
    back = state_to_numpy(state_from_numpy(st, "cpu"))
    assert back["iter"].dtype == np.int32 and int(back["iter"]) == 4
    with pytest.raises(KeyError):
        state_from_numpy({"x": np.zeros(2)}, "cpu")
    assert jnp.asarray(back["x"]).shape == (3,)
