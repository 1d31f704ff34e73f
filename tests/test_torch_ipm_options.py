"""The IPM's opt-in options through the port on the CPU, as the JAX
package's tests hold them (tests/test_ipm.py): ray damping leaves hs071's
trajectory untouched, the adaptive barrier and the least-squares dual start
reach the hs071 optimum with the JAX package's iteration counts,
``_lsq_duals`` equals the JAX package's at the same state, and on the
degenerate pandemic (25,4) the least-squares start beats y0 = 0."""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.ops import Core as JCore, abs2 as jabs2
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.interop import state_from_numpy
from infiniteexamodels_jl_torch.ops import Core as TCore, abs2 as tabs2
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.transcribe import transcribe as ttranscribe


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This module's solves run on one intra-op thread: their tensors are
    small, and test workers that each keep a pool of spinning OpenMP threads
    on the same cores slow one another several-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HS071 = 17.0140173


def _hs071(Core, abs2, **build):
    core = Core()
    x = core.add_var((4,), lvar=1.0, uvar=5.0,
                     start=np.array([1.0, 5.0, 5.0, 1.0]), name="x")
    core.add_obj(x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2])
    core.add_con(x[0] * x[1] * x[2] * x[3], lcon=25.0, ucon=np.inf)
    core.add_con(abs2(x[0]) + abs2(x[1]) + abs2(x[2]) + abs2(x[3]),
                 lcon=40.0, ucon=40.0)
    return core.build(**build)


def _solve_both(**opts):
    port = IpmSolver(_hs071(TCore, tabs2, device="cpu"), print_level=0,
                     **opts).solve()
    ref = JIpmSolver(_hs071(JCore, jabs2), print_level=0, **opts).solve()
    return port, ref


def test_ray_damping_noninterference():
    """The ray gate never opens on a regular NLP: bit-identical iterates."""
    r0 = IpmSolver(_hs071(TCore, tabs2, device="cpu"), print_level=0).solve()
    r1, ref = _solve_both(ray_damping=True)
    assert r1.status == "first_order"
    assert r1.iter == r0.iter == ref.iter
    np.testing.assert_array_equal(r1.solution, r0.solution)


@pytest.mark.parametrize("opts", [dict(barrier="adaptive"),
                                  dict(dual_init="lsq"),
                                  dict(prox_dual_kappa=1.0)],
                         ids=lambda o: next(iter(o)))
def test_option_reaches_hs071_with_the_jax_iterations(opts):
    port, ref = _solve_both(**opts)
    assert port.status == ref.status == "first_order"
    assert port.iter == ref.iter
    assert port.objective == pytest.approx(HS071, abs=1e-5)
    assert port.objective == pytest.approx(ref.objective, rel=1e-12)


def test_lsq_duals_match_jax():
    """``_lsq_duals`` (matrix-free CG on J J^T + I) at the JAX package's
    pushed-inside initial point of pandemic (25,4), carried across."""
    jm, _ = jtranscribe(jmodels.pandemic(num_supports=25, num_scenarios=4))
    js = JIpmSolver(jm, linear_solver="auto", print_level=0, tol=1e-6)
    consts = dict(js._compute_consts(jm.theta, jm))
    consts["fam"] = jm.fam_tables()
    consts["jac_rows"] = jm.jac_rows
    consts["jac_cols"] = jm.jac_cols
    st = js._init_jit(jm.x0, jm.y0, consts)
    want = np.asarray(js._ensure_lsq_jit()(st, consts))
    tm, _ = ttranscribe(tmodels.pandemic(num_supports=25, num_scenarios=4),
                        device="cpu")
    ts = IpmSolver(tm, linear_solver="auto", print_level=0, tol=1e-6)
    tst = state_from_numpy({k: np.asarray(v)
                            for k, v in st._asdict().items()}, "cpu")
    got = ts._lsq_duals(tst, ts._compute_consts(tm.theta, tm)).numpy()
    assert np.abs(want).max() > 1.0
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def test_lsq_dual_init_beats_zero_on_pandemic():
    """tests/test_ipm.py::test_lsq_dual_init through the port, with the cap
    at 600 iterations instead of 900: the y0 = 0 run ends at the cap
    either way (the JAX package: 900 -> 531 with the least-squares start;
    the port: 549)."""
    runs = {}
    for di in ("zero", "lsq"):
        m = tmodels.pandemic(num_supports=25, num_scenarios=4)
        b = ExaTranscriptionBackend(IpmSolver, device="cpu",
                                    linear_solver="auto", print_level=0,
                                    tol=1e-6, max_iter=600, dual_init=di)
        m.set_transformation_backend(b)
        b.build(m)
        runs[di] = b.optimize(m)
    assert runs["lsq"].status in ("first_order", "acceptable")
    assert runs["lsq"].objective == pytest.approx(runs["zero"].objective,
                                                  abs=1e-3)
    assert runs["lsq"].iter < runs["zero"].iter
