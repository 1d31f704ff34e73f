"""The low-precision step sets of the port (``factor_dtype="mixed"``,
``"float32"``, ``"ir32"``) against the JAX package's on the CPU.

- ``SimdModel.kkt_vals(dtype=float32)`` on quad-12 and farmer-32: an f32
  result within 1e-5 of the largest |value| of the JAX package's;
- the f32 band / block backend (``factor_dtype`` and ``assemble_dtype``
  float32) on quad-30 (band) and farmer-32 (``block_diag`` with a border):
  f32 blocks within 1e-5 and an f32 solve within 1e-4 of the JAX
  backend's, handed back in f64;
- farmer-32 and quad-12 at tol 1e-8 in each step set: ``first_order`` with
  the objective within 1e-9 relative of the JAX package's same step set
  and of the port's f64 solve;
- the host-return schedule ("mixed" on both): the JAX package's host
  loop, driving chunks whose steps are the port's, returns to the host at
  the iterations the port's own loop does.

f32 trajectories part between the packages: a condensed KKT of condition
~1e8 factored in f32 fixes a direction only to O(1), so the two packages'
f32 rounding (Hessian sweep, segment sums, Cholesky) takes different
line-search branches after a few steps (quad-12 "mixed": the same E0
through iteration 2, apart from iteration 3 on).  Iteration counts and
the handover are compared with the JAX package's within the stated bands;
the differences found are written beside each case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver
from infiniteexamodels_jl_tpu.solvers.block_tridiag import (
    BlockTridiagKKT as JBlockKKT)
from infiniteexamodels_jl_tpu.solvers.ipm import IpmState as JIpmState
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.interop import state_from_numpy, state_to_numpy
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.solvers.block_tridiag import BlockTridiagKKT
from infiniteexamodels_jl_torch.solvers.ipm import DEMOTE_F32, RUNNING
from infiniteexamodels_jl_torch.transcribe import transcribe as ttranscribe
from test_torch_ipm import QUAD12_F64

BUILD = {
    "quad12": lambda M: M.quad(num_supports=12),
    "quad30": lambda M: M.quad(num_supports=30),
    "farmer32": lambda M: M.farmer(num_scenarios=32),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: small tensors, and several test workers share
    the cores (each with its own OpenMP pool otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(name):
    jm, _ = jtranscribe(BUILD[name](jmodels))
    tm, _ = ttranscribe(BUILD[name](tmodels), device="cpu")
    return jm, tm


def _point(jm, seed):
    rng = np.random.default_rng(seed)
    return dict(x=np.asarray(jm.x0) + 0.01 * rng.standard_normal(jm.nvar),
                lam=0.1 * rng.standard_normal(jm.ncon),
                d=rng.uniform(1.0, 3.0, jm.ncon),
                diag=rng.uniform(2.0, 4.0, jm.nvar),
                rhs=rng.standard_normal(jm.nvar))


@pytest.mark.parametrize("name", ["quad12", "farmer32"])
def test_kkt_vals_f32_matches_jax(name):
    jm, tm = _both(name)
    pt = _point(jm, 3)
    want = np.asarray(jax.jit(
        lambda x, lam, d: jm.kkt_vals(x, jm.theta, lam, 1.0, d,
                                      dtype=jnp.float32))(
        jnp.asarray(pt["x"]), jnp.asarray(pt["lam"]), jnp.asarray(pt["d"])))
    got = tm.kkt_vals(torch.as_tensor(pt["x"]), tm.theta,
                      torch.as_tensor(pt["lam"]), 1.0,
                      torch.as_tensor(pt["d"]), dtype=torch.float32)
    # a tensor captured in f64 anywhere in the sweep would promote it
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("name,mode,mB", [("quad30", "band", 0),
                                          ("farmer32", "block_diag", 3)])
def test_f32_backend_matches_jax(name, mode, mB):
    jm, tm = _both(name)
    jb = JBlockKKT(jm, factor_dtype=jnp.float32)
    jb.assemble_dtype = jnp.float32
    tb = BlockTridiagKKT(tm, factor_dtype=torch.float32)
    tb.assemble_dtype = torch.float32
    assert (tb.mode, tb.mB) == (jb.mode, jb.mB) == (mode, mB)
    pt = _point(jm, 5)
    Kj = jax.jit(jb.assemble)(jnp.asarray(pt["x"]), jm.theta,
                              jnp.asarray(pt["lam"]), 1.0,
                              jnp.asarray(pt["d"]), jnp.asarray(pt["diag"]))
    Kt = tb.assemble(torch.as_tensor(pt["x"]), tm.theta,
                     torch.as_tensor(pt["lam"]), 1.0,
                     torch.as_tensor(pt["d"]), torch.as_tensor(pt["diag"]))
    for a, b in zip(Kj, Kt):
        a = np.asarray(a)
        assert b.dtype == torch.float32 and a.shape == tuple(b.shape)
        if a.size:
            assert np.abs(b.numpy() - a).max() <= 1e-5 * np.abs(a).max()
    ft, okt = tb.factor(Kt)
    fj, okj = jax.jit(jb.factor)(Kj)
    assert bool(okt) and bool(okj)
    tfac, Z, Ls, _, _ = ft
    assert Z.dtype == Ls.dtype == torch.float32
    xt = tb.solve(ft, torch.as_tensor(pt["rhs"]))
    xj = np.asarray(jax.jit(jb.solve)(fj, jnp.asarray(pt["rhs"])))
    assert xt.dtype == torch.float64
    assert np.abs(xt.numpy() - xj).max() <= 1e-4 * np.abs(xj).max()


# the port's f64 objectives at tol 1e-8: quad-12's (14 iterations) is
# test_torch_ipm.py::test_quad12_band_oracle_and_jax_iterations's, which
# solves it; farmer-32's (44 iterations) is solved here
@pytest.fixture(scope="module")
def port_f64():
    tm, _ = ttranscribe(BUILD["farmer32"](tmodels), device="cpu")
    farmer = IpmSolver(tm, linear_solver="auto", print_level=0,
                       tol=1e-8).solve()
    return {"quad12": QUAD12_F64, "farmer32": farmer.objective}


# the JAX package's solves at tol 1e-8 on the CPU, recorded by ``python -m
# tests.torch_vs_jax_trajectory --model <quad|farmer> --size <12|32> --tol
# 1e-8 --factor-dtype <set>`` (a quad-12 one takes ~50 s, most of it the
# compile): iterations, objective, and the iteration of the last f32 step
# (None: f32 to the end)
JAX_RECORDS = {
    ("quad12", "mixed"): (14, 574.5678887587922, 5),
    ("quad12", "float32"): (14, 574.5678887587922, 5),
    ("quad12", "ir32"): (20, 574.5678887587922, 10),
    ("farmer32", "mixed"): (44, -99407.5576883195, 34),
    ("farmer32", "float32"): (57, -99407.55768836022, 55),
    ("farmer32", "ir32"): (55, -99407.55768836023, None),
}
# found (the port on one thread: iterations, last f32 step): quad-12
# mixed 11, 3; float32 11, 3; ir32 14, 5 -- each handover a demotion, as
# in the JAX package; farmer-32 mixed 46, 34 (the mu switch, as the JAX
# package's), float32 58, 58 (the JAX package demotes at 55), ir32 54, 54.


class _Steps(IpmSolver):
    """Records (state in, f32 step set?, state out) of every step."""

    def solve(self, *a, **k):
        self.steps = []
        return super().solve(*a, **k)

    def _step(self, st, consts, kkt=None):
        out = super()._step(st, consts, kkt)
        self.steps.append((st, kkt is not None and kkt is self.kkt32, out))
        return out


def _jax_driven_host_returns(jm, fd, steps):
    """The JAX package's host loop (``solve``) with its initial state and
    its device chunks replaced by the port's: each chunk replays the port
    solve's steps while the JAX chunk's condition holds (RUNNING, under the
    cap, and for the f32 chunk mu above the switch), asserting that the
    JAX loop asks for each in turn, from the same iterate and in the same
    step set.  So one trajectory drives both loops, and their host returns
    compare the loops alone."""
    js = JIpmSolver(jm, linear_solver="auto", print_level=0, tol=1e-8,
                    factor_dtype=fd)
    replay = iter(steps)
    returns = []

    def to_jax(st):
        return JIpmState(**{k: jnp.asarray(v)
                            for k, v in state_to_numpy(st).items()})

    def chunk(jst, cap, f32, mu_switch=-np.inf):
        st = state_from_numpy({k: np.asarray(v)
                               for k, v in jst._asdict().items()}, "cpu")
        while (int(st.status) == RUNNING and int(st.iter) < int(cap)
               and float(st.mu) > float(mu_switch)):
            st_in, used32, out = next(replay)
            assert used32 == f32 and int(st_in.iter) == int(st.iter)
            assert torch.equal(st_in.x, st.x) and torch.equal(st_in.y, st.y)
            st = out
        returns.append(int(st.iter))
        jst = to_jax(st)
        return jst, js._probe_of(jst)

    js._init_jit = lambda *a, **k: to_jax(steps[0][0])
    js._run_jit = lambda st, c, cap: chunk(st, cap, False)
    js._run32_jit = lambda st, c, cap, mu_switch: chunk(st, cap, True,
                                                        mu_switch)
    res = js.solve()
    assert next(replay, None) is None          # every step was asked for
    return res, returns


@pytest.mark.parametrize("fd", ["mixed", "float32", "ir32"])
@pytest.mark.parametrize("name", ["quad12", "farmer32"])
def test_step_set_reaches_first_order(name, fd, port_f64):
    """Each step set on each model.  The "mixed" cases also hold the
    port's host-return schedule to the JAX package's host loop driving the
    same steps: quad-12 returns where its f32 chunk demotes and at the end,
    farmer-32 at the 32-step cap inside its f32 chunk, at that chunk's exit
    at the mu switch, and at the end."""
    tm, _ = ttranscribe(BUILD[name](tmodels), device="cpu")
    s = _Steps(tm, linear_solver="auto", print_level=0, tol=1e-8,
               factor_dtype=fd)
    assert s.kkt32 is not None and s.kkt32.factor_dtype == torch.float32
    r = s.solve()
    assert r.status == "first_order"
    jit, jobj, jend = JAX_RECORDS[name, fd]
    assert r.objective == pytest.approx(jobj, rel=1e-9)
    assert r.objective == pytest.approx(port_f64[name], rel=1e-9)
    f32 = [out for _, is32, out in s.steps if is32]
    assert f32
    # a demotion hands the unchanged iterate to the f64 step set for good
    for k, (st_in, is32, out) in enumerate(s.steps):
        if int(out.status) == DEMOTE_F32:
            assert is32 and int(out.iter) == int(st_in.iter)
            assert torch.equal(out.x, st_in.x)
            assert not any(step[1] for step in s.steps[k + 1:])
    # round-off in f32 moves the count and the handover (module docstring)
    assert abs(r.iter - jit) <= max(3, jit // 2), (r.iter, jit)
    end = int(f32[-1].iter)
    jend = jit if jend is None else jend
    assert abs(end - jend) <= max(3, jend // 2), (end, jend)
    if fd == "mixed":
        jm, _ = jtranscribe(BUILD[name](jmodels))
        jres, want = _jax_driven_host_returns(jm, fd, s.steps)
        assert jres.status == "first_order" and len(want) >= 2
        assert s.host_returns == want
        np.testing.assert_array_equal(jres.solution, r.solution)


def test_rounded_f32_factor_in_both_packages(capsys):
    """``tests/torch_vs_jax_trajectory.py --rounded-f32`` (the tool that
    gives both packages' f32 step sets the f64 factor rounded to f32, from
    outside either package): farmer-32 "mixed" at tol 1e-8 ends
    ``first_order`` in both at the same objective (1e-9 relative), with
    the f32 phase handed over at the same iteration and for the same
    reason."""
    import json
    from torch_vs_jax_trajectory import main

    assert main(["--model", "farmer", "--size", "32", "--tol", "1e-8",
                 "--factor-dtype", "mixed", "--rounded-f32"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    jax_run, port_run = lines[0]["jax"], lines[1]["port"]
    assert jax_run["status"] == port_run["status"] == "first_order"
    assert port_run["objective"] == pytest.approx(jax_run["objective"],
                                                  rel=1e-9)
    assert port_run["f32_until"] == jax_run["f32_until"]
    assert port_run["f32_steps"] == jax_run["f32_steps"] > 0
    # the wrap is undone: the f32 view factors in f32 again
    tm, _ = ttranscribe(BUILD["farmer32"](tmodels), device="cpu")
    kkt = BlockTridiagKKT(tm, factor_dtype=torch.float32)
    jm = _both("farmer32")[0]
    p = _point(jm, 0)
    K = kkt.assemble(torch.as_tensor(p["x"]), tm.theta,
                     torch.as_tensor(p["lam"]), 1.0,
                     torch.as_tensor(p["d"]), torch.as_tensor(p["diag"]))
    fac, ok = kkt.factor(K)
    assert bool(ok) and fac[1].dtype == torch.float32
