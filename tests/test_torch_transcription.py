"""The PyTorch port's transcription against the JAX package's: the same
model built in both packages must give EQUAL static tables (family gather
indices and data, bounds, starts, parameters, Jacobian/Hessian patterns),
for every model family; and tests/test_transcription.py's white-box
checks (starts, bounds, overrides, theta, restrictions, measure warnings,
the family count) through the port."""
import numpy as np
import pytest

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.transcribe import transcribe as ttranscribe

CASES = {
    # orthogonal collocation (the benchmark's main path)
    "quad12": lambda M: M.quad(num_supports=12),
    # backward finite differences
    "hovercraft41": lambda M: M.hovercraft(num_supports=41),
    # scenario families: expectations over sampled supports, first-stage
    # coupling, MvNormal and Uniform draws from the model's seed
    "farmer64": lambda M: M.farmer(num_scenarios=64),
    "design3node32": lambda M: M.design_3node(num_scenarios=32),
    "opf10": lambda M: M.opf(num_supports=10),
    "opf_static": lambda M: M.opf_static(),
    # time x scenario product grid with added supports
    "pandemic25x4": lambda M: M.pandemic(num_supports=25, num_scenarios=4),
    # Lobatto collocation with 4 nodes, front-loaded supports
    "kinetics30": lambda M: M.kinetic_control(num_supports=30),
}


def _both(case):
    build = CASES[case]
    jm, jdata = jtranscribe(build(jmodels))
    tm, tdata = ttranscribe(build(tmodels), device="cpu")
    return jm, tm


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_tables_equal(case):
    jm, tm = _both(case)
    assert (jm.nvar, jm.ncon, jm.ntheta) == (tm.nvar, tm.ncon, tm.ntheta)
    jf = jm.con_fams + jm.obj_fams
    tf = tm.con_fams + tm.obj_fams
    assert len(jf) == len(tf)
    for a, b in zip(jf, tf):
        assert (a.name, a.n, a.kx, a.kp, a.kf, a.offset) == \
            (b.name, b.n, b.kx, b.kp, b.kf, b.offset)
        assert np.array_equal(a.vidx, b.vidx)
        assert np.array_equal(a.pidx, b.pidx)
        assert np.array_equal(a.fdata, b.fdata)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bounds_starts_and_patterns_equal(case):
    jm, tm = _both(case)
    assert np.array_equal(jm._lcon_np, tm._lcon_np)
    assert np.array_equal(jm._ucon_np, tm._ucon_np)
    for name in ("x0", "lvar", "uvar", "theta"):
        assert np.array_equal(np.asarray(getattr(jm, name)),
                              getattr(tm, name).numpy()), name
    for name in ("jac_rows_np", "jac_cols_np", "hess_rows_np",
                 "hess_cols_np"):
        assert np.array_equal(getattr(jm, name), getattr(tm, name)), name


# -- tests/test_transcription.py, the white-box suite (the reference's
# test/transcription.jl), through the port
from infiniteexamodels_jl_torch.modeling import (  # noqa: E402
    InfiniteModel, OrthogonalCollocation, integral, deriv, sin, cos,
    DomainRestriction)


def build_mapping_model():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    x = m.infinite_parameter("x", domain=(-1, 1), num_supports=3,
                             derivative_method=OrthogonalCollocation(3))
    y = m.variable("y", deps=(t,), lb=np.cos, ub=1.0)
    q = m.variable("q", deps=(t, x), fix=42.0)
    w = m.variable("w", deps=(x,), lb=2.0, ub=np.sin, start=np.cos)
    z = m.variable("z", start=10.0)
    return m, t, x, y, q, w, z


def test_base_iterators_and_internal_supports():
    m, t, x, *_ = build_mapping_model()
    simd, data = ttranscribe(m, device="cpu")
    assert len(data.base_itrs) == 2
    assert sum(data.has_internal) == 1
    # OC(3) adds 1 internal node per interval: 3 public -> 2 intervals -> 5
    assert len(data.base_itrs[1]) == 5
    assert len(data.base_itrs[0]) == 5


def test_variable_mapping_and_function_bounds():
    m, t, x, y, q, w, z = build_mapping_model()
    y0 = y(0)
    y1 = y(1)
    y0.info.start = 0.5
    y1.info.lb = -np.inf
    y1.info.ub = 0.8
    q0 = q(0, x)
    q1 = q(1, x)
    q0.info.start = 10.0
    q1.info.fix = 5.0
    d1 = deriv(y, t)
    d2 = deriv(q, x, 2)
    simd, data = ttranscribe(m, device="cpu")
    core = simd.core
    zv = data.lookup(z)
    assert core.x0[zv.i] == 10.0
    assert core.lvar[zv.i] == -np.inf
    yvar = data.lookup(y)
    assert yvar.length == 5
    tgrid = np.linspace(0, 1, 5)
    np.testing.assert_allclose(
        core.lvar[yvar.offset + 1:yvar.offset + 4], np.cos(tgrid)[1:4])
    np.testing.assert_allclose(core.uvar[yvar.offset + 1:yvar.offset + 4], 1.0)
    qvar = data.lookup(q)
    nx = 5  # x supports incl. internal
    assert qvar.length == 5 * nx
    assert qvar.shape == (5, nx)
    inner = core.lvar[qvar.offset + nx:qvar.offset + 4 * nx]
    np.testing.assert_allclose(inner, 42.0)
    wvar = data.lookup(w)
    xg = m.groups[1].supports()
    np.testing.assert_allclose(core.lvar[wvar.offset:wvar.offset + 5], 2.0)
    np.testing.assert_allclose(core.uvar[wvar.offset:wvar.offset + 5],
                               np.sin(xg))
    np.testing.assert_allclose(core.x0[wvar.offset:wvar.offset + 5],
                               np.cos(xg))
    assert data.lookup(d1).length == 5
    assert data.lookup(d2).length == 5 * nx
    assert len(m.all_derivatives()) == 3  # d2 lowered adds the chain deriv
    # point-variable overrides (transcription.jl:78-87)
    y0e = data.lookup(y0)
    assert core.x0[y0e.i] == 0.5
    assert core.lvar[y0e.i] == np.cos(0.0)
    y1e = data.lookup(y1)
    assert core.lvar[y1e.i] == -np.inf
    assert core.uvar[y1e.i] == 0.8
    # semi-infinite overrides on slices (transcription.jl:66-74)
    q0v, q0idx = data.semivar_info[id(q0)]
    assert q0idx[0] == 0 and isinstance(q0idx[1], str)
    assert core.x0[qvar[0, 1].i] == 10.0
    assert core.lvar[qvar[4, 2].i] == 5.0
    assert core.uvar[qvar[4, 3].i] == 5.0


def test_finite_parameters_in_theta():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    xp = m.finite_parameter("x", 42.0)
    y1 = m.finite_parameter("y1", 20.0)
    y2 = m.finite_parameter("y2", 30.0)
    v = m.variable("v", deps=(t,), lb=0, ub=100)
    m.constraint(v >= xp * 0 + y1 - y1)  # keep params used
    simd, data = ttranscribe(m, device="cpu")
    assert len([k for k in (xp, y1, y2) if data._get(data.param_map, k)]) == 3
    th = simd.theta.numpy()
    vals = sorted([th[data.lookup(xp).offset], th[data.lookup(y1).offset],
                   th[data.lookup(y2).offset]])
    assert vals == [20.0, 30.0, 42.0]


def test_parameter_function_grid():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    s = m.infinite_parameter("s", domain=(2, 3), num_supports=3)
    pf = m.parameter_function(lambda tv, sv: np.sin(tv) * sv, (t, s))
    v = m.variable("v", deps=(t, s))
    m.constraint(v >= pf)
    simd, data = ttranscribe(m, device="cpu")
    par = data.lookup(pf)
    assert par.shape == (3, 3)
    grid = simd.theta.numpy()[par.offset:par.offset + 9].reshape(3, 3)
    tg = np.linspace(0, 1, 3)
    sg = np.linspace(2, 3, 3)
    np.testing.assert_allclose(grid, np.sin(tg)[:, None] * sg[None, :])


def test_domain_restriction_filters_iterator():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    x = m.infinite_parameter("x", domain=(-1, 1), num_supports=5)
    y = m.variable("y", deps=(t, x), lb=0)
    z = m.variable("z")
    cref = m.constraint(y + z <= 42 + t,
                        restriction=DomainRestriction(
                            lambda sv: 0 <= sv <= 0.5, t))
    simd, data = ttranscribe(m, device="cpu")
    # t in {0,.25,.5} pass the restriction -> 3 * 5 rows
    assert len(data.lookup_constraint(cref)) == 15


def test_objective_measure_structures_no_warn():
    """The 'good' objective structures transcribe without the expansion
    warning (reference transcription.jl:177-209)."""
    import warnings as W

    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=5)
    x = m.infinite_parameter("x", domain=(-1, 1), num_supports=5)
    y = m.variable("y", deps=(t, x), lb=0)
    z = m.variable("z", start=10)
    inner = integral(y**2, t)
    good = [
        integral(inner, x) + 2 * y(0, 1),
        integral(inner + 2 * z, x),
        integral(inner + 2 * z**2, x) + 2 * y(0, 1),
        integral(inner + sin(z**2), x),
        integral(inner * cos(z), x),
        integral(z * (inner + z**3), x),
    ]
    for obj in good:
        m.minimize(obj)
        with W.catch_warnings():
            W.simplefilter("error")
            ttranscribe(m, device="cpu")


def test_objective_measure_fallback_warns():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    x = m.infinite_parameter("x", domain=(-1, 1), num_supports=3)
    y = m.variable("y", deps=(t, x), lb=0)
    inner = integral(y**2, t)
    for obj in (integral(inner**2, x), integral(inner, x)**2,
                integral(inner * inner, x)):
        m.minimize(obj)
        with pytest.warns(UserWarning, match="heuristics"):
            ttranscribe(m, device="cpu")


def test_constraint_measure_warns_and_expands():
    m = InfiniteModel()
    t = m.infinite_parameter("t", domain=(0, 1), num_supports=3)
    y = m.variable("y", deps=(t,), lb=0)
    z = m.variable("z")
    cref = m.constraint(integral(y, t) + z <= 1)
    with pytest.warns(UserWarning, match="Constrained measures"):
        simd, data = ttranscribe(m, device="cpu")
    assert len(data.lookup_constraint(cref)) == 1


def test_template_count_independent_of_supports():
    """The family count does not grow with the support count (the SIMD
    invariant, SURVEY.md §3.4)."""
    def nfam(ns):
        m = InfiniteModel()
        t = m.infinite_parameter("t", domain=(0, 1), num_supports=ns)
        y = m.variable("y", deps=(t,), lb=0)
        u = m.variable("u", deps=(t,))
        m.constraint(deriv(y, t) == -y + u)
        m.constraint(y(0) == 1)
        m.minimize(integral(u**2 + y**2, t))
        simd, _ = ttranscribe(m, device="cpu")
        return len(simd.con_fams) + len(simd.obj_fams)

    assert nfam(5) == nfam(50) == nfam(500)
