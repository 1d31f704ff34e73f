"""The tests of tests/test_ipm.py that have no counterpart elsewhere in the
port's tests, through the port on the CPU: the classic NLPs at their
literature oracles with the JAX package's iteration counts, warm start, the
max_iter / max_wall_time / unbounded statuses, the feasibility restoration
phase, the second-order correction (slow, as in the JAX package), the
sticky regularization streak, the consts cache and the best-iterate
objective guard.  (``test_profiler_trace_dir``,
``test_ray_damping_noninterference``, ``test_adaptive_barrier`` and
``test_lsq_dual_init`` are ported in tests/test_torch_checkpoint.py and
tests/test_torch_ipm_options.py.)"""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu import ops as jops
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver
from infiniteexamodels_jl_torch import ops as tops
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.transcribe import transcribe


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: small tensors, and several test workers share
    the cores (each with its own OpenMP pool otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(P, core):
    return core.build(device="cpu") if P is tops else core.build()


def bound_qp(P):
    core = P.Core()
    x = core.add_var((), uvar=1.0, name="x")
    core.add_obj(P.abs2(x.entry() - 2.0))
    return build(P, core)


def rosenbrock(P):
    core = P.Core()
    v = core.add_var((2,), start=np.array([-1.2, 1.0]), name="v")
    core.add_obj(100.0 * P.abs2(v[1] - P.abs2(v[0])) + P.abs2(1.0 - v[0]))
    return build(P, core)


def hs071(P, equality=True):
    core = P.Core()
    x = core.add_var((4,), lvar=1.0, uvar=5.0,
                     start=np.array([1.0, 5.0, 5.0, 1.0]), name="x")
    core.add_obj(x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2])
    core.add_con(x[0] * x[1] * x[2] * x[3], lcon=25.0, ucon=np.inf)
    if equality:
        core.add_con(P.abs2(x[0]) + P.abs2(x[1]) + P.abs2(x[2])
                     + P.abs2(x[3]), lcon=40.0, ucon=40.0)
    return build(P, core)


def maximize(P):
    core = P.Core(minimize=False)
    x = core.add_var((), lvar=0.0, uvar=4.0, name="x")
    core.add_obj(x.entry() * (4.0 - x.entry()))
    return build(P, core)


def equality_lp(P):
    # min x + y  s.t.  x + 2y == 3, x >= 0, y >= 0
    core = P.Core()
    x = core.add_var((), lvar=0.0, name="x")
    y = core.add_var((), lvar=0.0, name="y")
    core.add_obj(x.entry() + y.entry())
    core.add_con(x.entry() + 2.0 * y.entry(), lcon=3.0, ucon=3.0)
    return build(P, core)


def simd_family(P):
    # min sum_i (x_i - 1)^2  s.t. x_i - x_{i-1} <= 0.3, x_0 == 0
    core = P.Core()
    n = 8
    x = core.add_var((n,), name="x")
    core.add_con(x[P.SRC.i] - x[P.SRC.i - 1],
                 P.Iterator({"i": np.arange(1, n)}), lcon=-np.inf, ucon=0.3)
    core.add_con(x[0], lcon=0.0, ucon=0.0)
    core.add_obj(P.abs2(x[P.SRC.i] - 1.0), P.Iterator({"i": np.arange(n)}))
    return build(P, core)


# problem: (builder, objective oracle, solution oracle, tolerance)
CLASSIC = {
    "bound_qp": (bound_qp, 1.0, [1.0], 1e-7),
    "rosenbrock_unconstrained": (rosenbrock, None, [1.0, 1.0], 1e-6),
    "hs071": (hs071, 17.0140173,
              [1.0, 4.7429994, 3.8211503, 1.3794082], 1e-5),
    "maximize": (maximize, 4.0, [2.0], 1e-6),
    "equality_lp": (equality_lp, 1.5, [0.0, 1.5], 1e-6),
    "simd_family_problem": (simd_family, None,
                            np.minimum(np.arange(8) * 0.3, 1.0), 1e-6),
}


@pytest.mark.parametrize("name", sorted(CLASSIC))
def test_classic_problem(name):
    """test_bound_qp, test_rosenbrock_unconstrained, test_hs071,
    test_maximize, test_equality_lp and test_simd_family_problem: the
    literature oracle at the JAX test's tolerance, the JAX package's
    iteration count, and its objective to 1e-9."""
    make, obj, sol, tol = CLASSIC[name]
    res = IpmSolver(make(tops), print_level=0).solve()
    ref = JIpmSolver(make(jops), print_level=0).solve()
    assert res.status == ref.status == "first_order"
    np.testing.assert_allclose(res.solution, sol, atol=tol)
    if obj is not None:
        assert res.objective == pytest.approx(obj, abs=tol)
    assert res.iter == ref.iter
    assert res.objective == pytest.approx(ref.objective, rel=1e-9, abs=1e-12)


def test_warmstart_fewer_iters():
    m = hs071(tops)
    s = IpmSolver(m, print_level=0)
    cold = s.solve()
    m.set_x0(cold.solution)
    m.set_y0(cold.multipliers)
    warm = s.reset().solve(mu_init=1e-7)
    assert warm.status == "first_order"
    assert warm.iter < cold.iter
    assert warm.objective == pytest.approx(cold.objective, abs=1e-6)


def test_max_iter_status():
    res = IpmSolver(hs071(tops, equality=False), print_level=0,
                    max_iter=2).solve()
    assert res.status == "max_iter"
    assert res.iter == 2


def test_max_wall_time_status():
    core = tops.Core()
    n = 50
    x = core.add_var((n,), name="x")
    core.add_con(x[tops.SRC.i] - x[tops.SRC.i - 1] * x[tops.SRC.i - 1],
                 tops.Iterator({"i": np.arange(1, n)}), lcon=0.1, ucon=0.1)
    core.add_obj(tops.abs2(x[tops.SRC.i] - 2.0),
                 tops.Iterator({"i": np.arange(n)}))
    m = core.build(device="cpu")
    res = IpmSolver(m, print_level=0, max_wall_time=1e-9).solve()
    assert res.status == "max_time"


def test_unbounded_detection():
    """min x, unbounded below: the port ends as the JAX package does."""
    def make(P):
        core = P.Core()
        x = core.add_var((), name="x")
        core.add_obj(x.entry())
        return build(P, core)
    res = IpmSolver(make(tops), print_level=0, max_iter=500).solve()
    ref = JIpmSolver(make(jops), print_level=0, max_iter=500).solve()
    assert res.status in ("unbounded", "max_iter", "stalled")
    if res.status == "unbounded":
        assert res.objective < -1e19
    assert (res.status, res.iter) == (ref.status, ref.iter)


def _restoration_problem(P):
    core = P.Core()
    x = core.add_var((4,), start=5.0)
    core.add_con(x[P.SRC.i] * x[P.SRC.i + 1] - 1.0,
                 P.Iterator({"i": np.arange(3)}), 0.0, 0.0)
    core.add_obj(P.abs2(x[P.SRC.i] - 2.0), P.Iterator({"i": np.arange(4)}))
    return build(P, core)


def test_restoration_reduces_violation_and_resumes():
    """From a violated state the restoration phase cuts the violation by
    four orders of magnitude and hands back a RUNNING state; the full
    solve still certifies."""
    m = _restoration_problem(tops)
    s = IpmSolver(m, print_level=0, tol=1e-8)
    consts = s._compute_consts(m.theta, m)
    st = s._init_state(m.x0, m.y0, consts)
    viol0 = float(s._ceval(st.x, consts).abs().max())
    st2 = s._restore(st, consts)
    viol1 = float(s._ceval(st2.x, consts).abs().max())
    assert viol0 > 1.0
    assert viol1 < 1e-4 * viol0
    assert int(st2.status) == 0
    assert int(st2.ls_fail_count) == 0
    assert s.solve().status == "first_order"


def test_restoration_disabled_falls_back_to_stalled():
    """With restoration off, repeated line-search failures end in the
    stalled family of statuses, as in the JAX package."""
    def make(P):
        core = P.Core()
        x = core.add_var((2,), start=0.0)
        # infeasible pair: x0 == 1 and x0 == -1
        core.add_con(x[0], lcon=1.0, ucon=1.0)
        core.add_con(x[0], lcon=-1.0, ucon=-1.0)
        core.add_obj(P.abs2(x[0]) + P.abs2(x[1]))
        return build(P, core)
    ends = ("stalled", "infeasible", "max_iter", "acceptable")
    for resto in (False, True):
        res = IpmSolver(make(tops), print_level=0, restoration=resto,
                        max_iter=200).solve()
        ref = JIpmSolver(make(jops), print_level=0, restoration=resto,
                         max_iter=200).solve()
        assert res.status in ends
        assert res.status == ref.status


@pytest.mark.slow
def test_second_order_correction():
    """SOC on and off converge to the same quad-40 point (tol 1e-8)."""
    simd, _ = transcribe(tmodels.quad(num_supports=40), device="cpu")
    r_on = IpmSolver(simd, print_level=0, linear_solver="auto",
                     tol=1e-8, soc=True).solve()
    r_off = IpmSolver(simd, print_level=0, linear_solver="auto",
                      tol=1e-8, soc=False).solve()
    assert r_on.status == "first_order"
    assert r_off.status == "first_order"
    assert r_on.objective == pytest.approx(r_off.objective, rel=1e-9)


def test_sticky_regularization_streak():
    """The indefinite Hessian (-2I) defeats the delta_w = 0 probe for
    several steps: the streak accrues and delta_w stays positive; with the
    skip policy off the solve lands on the same optimum."""
    def make():
        core = tops.Core()
        x = core.add_var((2,), lvar=-1.0, uvar=2.0,
                         start=np.array([0.3, 0.4]), name="x")
        core.add_obj(-tops.abs2(x[0]) - tops.abs2(x[1]))
        return core.build(device="cpu")

    m = make()
    res = IpmSolver(m, print_level=0).solve()
    assert res.status == "first_order"
    assert res.objective == pytest.approx(-8.0, abs=1e-6)
    res_noskip = IpmSolver(m, print_level=0,
                           reg_zero_skip_streak=10**6).solve()
    assert res_noskip.status == "first_order"
    assert res_noskip.objective == pytest.approx(res.objective, abs=1e-9)
    s = IpmSolver(m, print_level=0)
    consts = s._compute_consts(m.theta, m)
    st = s._init_state(m.x0, m.y0, consts)
    streaks, dws = [], []
    for _ in range(5):
        st = s._step(st, consts)
        streaks.append(int(st.zero_fail_streak))
        dws.append(float(st.log_delta_w))
    assert streaks[0] >= 1
    assert max(streaks) >= 2
    assert all(d > 0.0 for d in dws[:2])


def test_consts_cache_invalidation():
    """The solver's cached problem constants are keyed on a fingerprint of
    theta, x0 and the bounds: a plain re-solve hits the cache, a warm
    start through the core misses it and still certifies."""
    mdl = tmodels.farmer(num_scenarios=16)
    b = ExaTranscriptionBackend(IpmSolver, device="cpu",
                                linear_solver="auto", print_level=0,
                                tol=1e-6)
    mdl.set_transformation_backend(b)
    b.build(mdl)
    r0 = b.optimize(mdl)
    assert r0.status == "first_order"
    solver = b.solver
    assert solver._consts_cache is not None
    fp0 = solver._consts_cache[0]
    b.model.refresh_from_core()
    assert solver._compute_consts(b.model.theta, b.model) is \
        solver._consts_cache[1]
    b.model.core.set_x0_flat(np.asarray(r0.solution))
    b.model.refresh_from_core()
    solver._compute_consts(b.model.theta, b.model)
    assert solver._consts_cache[0] != fp0
    r1 = b.optimize(mdl)
    assert r1.status == "first_order"
    assert r1.objective == pytest.approx(r0.objective, rel=1e-6)


def test_restore_objective_guard():
    """A near-KKT iterate whose objective sits far above the best feasible
    objective seen is neither stored for the restore nor counted as a
    near-optimal visit."""
    core = tops.Core()
    x = core.add_var((2,), start=np.array([3.0, 1.0]), lvar=0.0)
    core.add_obj(tops.abs2(x[0] - 1.0) + tops.abs2(x[1] - 2.0))
    core.add_con(x[0] + x[1], lcon=1.0, ucon=np.inf)
    m = core.build(device="cpu")
    s = IpmSolver(m, print_level=0, tol=1e-8)
    consts = s._compute_consts(m.theta, m)
    st = s._init_state(m.x0, m.y0, consts)
    for _ in range(12):
        st = s._step(st, consts)
    assert int(st.status) == 1
    assert float(st.best_E) < 1e-6
    bound = float(st.feas_fobj) + 0.1 * max(1.0, abs(float(st.feas_fobj)))
    assert float(st.best_fobj) <= bound
    # replay the final step from a state that claims a far lower feasible
    # objective: the same iterate is rejected
    sab = st._replace(status=torch.tensor(0, dtype=torch.int32),
                      feas_fobj=torch.tensor(-1e3, dtype=st.feas_fobj.dtype),
                      acc_visits=torch.tensor(0, dtype=torch.int32))
    st2 = s._step(sab, consts)
    assert not np.isfinite(float(st2.best_E))
    assert int(st2.acc_visits) == 0
