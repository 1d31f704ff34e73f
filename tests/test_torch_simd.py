"""The PyTorch port's SimdModel against the JAX package's on quad-12: every
evaluation method at one seeded point, f64, rtol 1e-12 / atol 1e-14 (the two
packages' sin/cos differ by a few ulp and sum in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.ops import Core as JCore, Iterator as JIter
from infiniteexamodels_jl_tpu.ops import SRC as JSRC
from infiniteexamodels_jl_tpu.ops.expr import JNP_OPS
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.ops import Core as TCore, Iterator as TIter
from infiniteexamodels_jl_torch.ops import SRC as TSRC
from infiniteexamodels_jl_torch.ops.expr import TORCH_OPS
from infiniteexamodels_jl_torch.transcribe import transcribe as ttranscribe

RTOL, ATOL = 1e-12, 1e-14


@pytest.fixture(scope="module")
def pair():
    jm, _ = jtranscribe(jmodels.quad(num_supports=12))
    tm, _ = ttranscribe(tmodels.quad(num_supports=12), device="cpu")
    rng = np.random.default_rng(0)
    pt = dict(
        x=np.asarray(jm.x0) + 0.1 * rng.standard_normal(jm.nvar),
        theta=np.asarray(jm.theta) + 0.01 * rng.standard_normal(jm.ntheta),
        lam=rng.standard_normal(jm.ncon),
        sigma=0.7,
        d=rng.uniform(0.5, 2.0, jm.ncon),
        v=rng.standard_normal(jm.nvar),
        w=rng.standard_normal(jm.ncon),
    )
    return jm, tm, pt


def _j(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


def _t(a):
    return torch.as_tensor(a) if isinstance(a, np.ndarray) else a


def _close(jout, tout):
    if isinstance(jout, tuple):
        for a, b in zip(jout, tout):
            _close(a, b)
        return
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)


CALLS = {
    "obj": lambda m, p: m.obj(p["x"], p["theta"]),
    "grad": lambda m, p: m.grad(p["x"], p["theta"]),
    "cons": lambda m, p: m.cons(p["x"], p["theta"]),
    "obj_and_grad": lambda m, p: m.obj_and_grad(p["x"], p["theta"]),
    "cons_and_jac": lambda m, p: m.cons_and_jac(p["x"], p["theta"]),
    "jac_vals": lambda m, p: m.jac_vals(p["x"], p["theta"]),
    "hess_vals": lambda m, p: m.hess_vals(p["x"], p["theta"], p["lam"],
                                          p["sigma"]),
    "kkt_vals": lambda m, p: m.kkt_vals(p["x"], p["theta"], p["lam"],
                                        p["sigma"], p["d"]),
    "hvp_lag": lambda m, p: m.hvp_lag(p["x"], p["theta"], p["lam"],
                                      p["sigma"], p["v"]),
    "jprod": lambda m, p: m.jprod(m.jac_vals(p["x"], p["theta"]), p["v"]),
    "jtprod": lambda m, p: m.jtprod(m.jac_vals(p["x"], p["theta"]),
                                    p["w"]),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_method_matches_jax(pair, name):
    jm, tm, pt = pair
    # jit: one XLA compile of the whole sweep instead of op-by-op dispatch
    jout = jax.jit(lambda p: CALLS[name](jm, p))(
        {k: _j(v) for k, v in pt.items()})
    tout = CALLS[name](tm, {k: _t(v) for k, v in pt.items()})
    _close(jout, tout)


def test_updates_fingerprint_and_queries(pair):
    jm, tm, pt = pair
    assert jm.consts_fingerprint() == tm.consts_fingerprint()
    par = tm.core.parameters[0]
    jpar = jm.core.parameters[0]
    vals = np.linspace(0.0, 1.0, par.length)
    jm.set_parameter(jpar, vals)
    tm.set_parameter(par, vals)
    assert np.array_equal(np.asarray(jm.theta), tm.theta.numpy())
    assert np.array_equal(jm.theta_view(jpar), tm.theta_view(par))
    jm.set_x0(pt["x"])
    tm.set_x0(pt["x"])
    assert np.array_equal(np.asarray(jm.x0), tm.x0.numpy())
    jm.set_y0(pt["lam"])
    tm.set_y0(pt["lam"])
    assert np.array_equal(np.asarray(jm.y0), tm.y0.numpy())
    assert jm.consts_fingerprint() == tm.consts_fingerprint()
    var = tm.core.variables[3]
    assert np.array_equal(jm.solution(pt["x"], jm.core.variables[3]),
                          tm.solution(torch.as_tensor(pt["x"]), var))
    for jf, tf in zip(jm.core.con_families, tm.core.con_families):
        assert np.array_equal(jm.multipliers(pt["lam"], jf),
                              tm.multipliers(torch.as_tensor(pt["lam"]), tf))
    jm.refresh_from_core()
    tm.refresh_from_core()
    assert np.array_equal(np.asarray(jm.x0), tm.x0.numpy())


def test_cbrt_value_and_gradient():
    a = np.array([-8.0, -0.3, 0.5, 27.0, 1e-3])
    jv = np.asarray(JNP_OPS["cbrt"](jnp.asarray(a)))
    jg = np.asarray(jax.vmap(jax.grad(JNP_OPS["cbrt"]))(jnp.asarray(a)))
    ta = torch.as_tensor(a)
    tv = TORCH_OPS["cbrt"](ta).numpy()
    tg = torch.func.vmap(torch.func.grad(TORCH_OPS["cbrt"]))(ta).numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-15, atol=0)
    np.testing.assert_allclose(tg, jg, rtol=1e-14, atol=0)
    assert set(TORCH_OPS) == set(JNP_OPS)


def test_slot_aliasing_hessian():
    """x[i] and x[0] alias at row 0: the cross Hessian terms must land on
    the diagonal with multiplicity 2 (test_ops.py's case, both packages)."""
    out = []
    for Core, Iterator, SRC, conv in (
            (JCore, JIter, JSRC, jnp.asarray),
            (TCore, TIter, TSRC, torch.as_tensor)):
        core = Core()
        x = core.add_var((3,), name="x")
        core.add_con(x[SRC.i] * x[0], Iterator({"i": np.arange(3)}),
                     lcon=0, ucon=0)
        m = core.build() if Core is JCore else core.build(device="cpu")
        hv = np.asarray(m.hess_vals(conv(np.array([2.0, 3.0, 4.0])),
                                    m.theta, conv(np.ones(3)), 1.0))
        H = np.zeros((3, 3))
        np.add.at(H, (m.hess_rows_np, m.hess_cols_np), hv)
        out.append(H)
    Htrue = np.array([[2.0, 1.0, 1.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    np.testing.assert_allclose(out[1], Htrue, atol=1e-12)
    np.testing.assert_array_equal(out[1], out[0])
