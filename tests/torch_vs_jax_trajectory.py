"""The port against the JAX package on the host CPU, one model at one size.

    python -m tests.torch_vs_jax_trajectory --model opf --size 1000
    python -m tests.torch_vs_jax_trajectory --model quad --size 1000 \
        --factor-dtype mixed
    python -m tests.torch_vs_jax_trajectory --model opf --size 1000 \
        --factor-dtype mixed --rounded-f32

Both packages solve the same model through ``ExaTranscriptionBackend(
IpmSolver, linear_solver="auto", tol=1e-6)`` (``--tol`` and
``--factor-dtype`` and ``--max-iter`` change those options); ``--size`` is
the OPF's scenarios, the farmer's scenarios, the quadrotor's or the
kinetics model's supports, or the pandemic's ``NT,NXI``.
``--certificate`` solves pandemic as the JAX package's (100,32)
certificate test does (elastic cap, least-squares dual start, the
stall-triggered recalc, max_iter 900); ``lsq_recalcs`` lists the
iterations at which each package recalculated its duals.  ``--no-e0``
skips the third solve (the JAX package's E0 log).  Prints one
JSON object per line:

- ``jax`` and ``port``: status, iterations, objective and wall seconds of
  each solve (the JAX time includes its compile), the iterations at which
  the solve returned to the host, and where a low-precision step set
  handed over to f64 (``f32_until``: the iteration of its last f32 step
  and ``"demotion"`` or ``"mu_switch"``; null when it ran in f32 to the
  end or not at all);
- ``e0``: the scaled KKT error E0 after every iteration in both, and the
  first iteration (counted from 1) at which the port's leaves the JAX
  package's by more than 1e-9 relative.

With ``--rounded-f32`` both packages' f32 step sets get a more accurate
f32 solve: the f32 view of the band/scenario KKT factors the same K in f64
and hands back that factor rounded to f32 (both packages'
``BlockTridiagKKT.factor`` wrapped from here; neither package's files
change).  ``f32_steps`` counts the steps each solve took in its f32 step
set.

The JAX package records E0 through its one-step-per-round-trip loop
(``print_level=5``, whose log goes to a discarded buffer); with the default
options that loop takes the same steps as its 32-step device chunks.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import time

import jax
import jax.numpy as jnp
import torch

jax.config.update("jax_platforms", "cpu")

from infiniteexamodels_jl_tpu import models as jmodels  # noqa: E402
from infiniteexamodels_jl_tpu.backend import (  # noqa: E402
    ExaTranscriptionBackend as JBackend)
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver  # noqa: E402
from infiniteexamodels_jl_tpu.solvers import (  # noqa: E402
    block_tridiag as jblock)
from infiniteexamodels_jl_torch.solvers import (  # noqa: E402
    block_tridiag as tblock)
from infiniteexamodels_jl_torch import models as tmodels  # noqa: E402
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend  # noqa: E402
from infiniteexamodels_jl_torch.solvers import IpmSolver  # noqa: E402
from infiniteexamodels_jl_torch.solvers.ipm import DEMOTE_F32  # noqa: E402

def _pandemic(M, size):
    nt, nxi = (int(v) for v in size.split(","))
    return M.pandemic(num_supports=nt, num_scenarios=nxi)


def _pandemic_elastic(M, size):
    nt, nxi = (int(v) for v in size.split(","))
    return M.pandemic(num_supports=nt, num_scenarios=nxi, elastic_rho=500.0)


# the options of the JAX package's pandemic (100,32) certificate
# (tests/test_models.py::test_pandemic_stall_recalc_100x32)
CERTIFICATE = dict(max_iter=900, dual_init="lsq", recalc_y_stall=True)


MODELS = {
    "opf": lambda M, n: M.opf(num_supports=int(n)),
    "farmer": lambda M, n: M.farmer(num_scenarios=int(n)),
    "quad": lambda M, n: M.quad(num_supports=int(n)),
    "kinetics": lambda M, n: M.kinetic_control(num_supports=int(n)),
    "pandemic": _pandemic,
}


class _JaxReturns(JIpmSolver):
    """Records every device chunk's return: (f32?, status code, iter), and
    the iteration of every least-squares dual recalc."""
    chunks = []
    lsq = []

    def _ensure_lsq_jit(self):
        lsq = super()._ensure_lsq_jit()

        def recorded(st, consts):
            _JaxReturns.lsq.append(int(st.iter))
            return lsq(st, consts)
        return recorded

    def _build_jits(self):
        super()._build_jits()
        for attr, f32 in (("_run_jit", False), ("_run32_jit", True)):
            run = getattr(self, attr)
            if run is None:
                continue

            def recording(*a, run=run, f32=f32):
                st, probe = run(*a)
                _JaxReturns.chunks.append((f32, int(probe[0]),
                                           int(probe[1])))
                return st, probe
            setattr(self, attr, recording)


def _f32_until(steps):
    """(iteration, cause) of the last f32 step of ``steps``, a list of
    (f32?, status code, iter), when f64 steps followed it."""
    last = max((i for i, s in enumerate(steps) if s[0]), default=None)
    if last is None or last == len(steps) - 1:
        return None
    return {"iteration": steps[last][2],
            "by": "demotion" if steps[last][1] == DEMOTE_F32
            else "mu_switch"}


def _f32_steps(chunks):
    """Steps of the JAX solve in its f32 step set: each f32 chunk's
    iterations (from the previous chunk's end)."""
    steps, last = 0, 0
    for f32, _, it in chunks:
        steps += (it - last) if f32 else 0
        last = it
    return steps


class _JaxE0(JIpmSolver):
    """Records E0 at every host round-trip (one per step at print_level 5)."""
    e0 = []

    def _build_jits(self):
        super()._build_jits()
        probe = self._probe_of

        def recording(st):
            _JaxE0.e0.append(float(st.log_E0))
            return probe(st)
        self._probe_of = recording


class _PortE0(IpmSolver):
    e0 = []
    steps = []      # (f32?, status code, iter) of every step
    lsq = []        # the iteration of every least-squares dual recalc

    def _lsq_duals(self, st, consts):
        _PortE0.lsq.append(int(st.iter))
        return super()._lsq_duals(st, consts)

    def _step(self, st, consts, kkt=None):
        st = super()._step(st, consts, kkt)
        _PortE0.e0.append(float(st.log_E0))
        _PortE0.steps.append((kkt is not None and kkt is self.kkt32,
                              int(st.status), int(st.iter)))
        return st


def _torch_map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_torch_map(fn, t) for t in tree)
    return fn(tree)


def _rounded(factor, to64, tree_map, cast):
    """``factor`` of a KKT class, made to factor an f32 view's K in f64
    and round the factor to the view's dtype (f64 views unchanged)."""
    def rounded(self, K):
        fdt = self.factor_dtype
        if fdt is None:
            return factor(self, K)
        view = copy.copy(self)
        view.factor_dtype = None
        fac, ok = factor(view, tuple(to64(k) for k in K))
        return tree_map(lambda a: cast(a, fdt), fac), ok
    return rounded


@contextlib.contextmanager
def rounded_f32_factors():
    """Both packages' f32 views factor in f64 and round the factor to f32
    (``--rounded-f32``)."""
    jfac, tfac = jblock.BlockTridiagKKT.factor, tblock.BlockTridiagKKT.factor
    jblock.BlockTridiagKKT.factor = _rounded(
        jfac, lambda a: a.astype(jnp.float64), jax.tree_util.tree_map,
        lambda a, dt: a.astype(dt) if jnp.issubdtype(a.dtype, jnp.floating)
        else a)
    tblock.BlockTridiagKKT.factor = _rounded(
        tfac, lambda a: a.to(torch.float64), _torch_map,
        lambda a, dt: a.to(dt) if a.is_floating_point() else a)
    try:
        yield
    finally:
        jblock.BlockTridiagKKT.factor = jfac
        tblock.BlockTridiagKKT.factor = tfac


def _solve(backend, M, build, size, **kw):
    m = build(M, size)
    b = backend(linear_solver="auto", **kw)
    m.set_transformation_backend(b)
    t0 = time.time()
    b.build(m)
    res = b.optimize(m)
    return {"status": res.status, "iterations": res.iter,
            "objective": res.objective, "primal_feas": res.primal_feas,
            "dual_feas": res.dual_feas, "wall_s": time.time() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="opf")
    ap.add_argument("--size", default="64")
    ap.add_argument("--max-iter", type=int, default=3000)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--factor-dtype", default="float64",
                    choices=("float64", "mixed", "float32", "ir32"))
    ap.add_argument("--rounded-f32", action="store_true")
    ap.add_argument("--certificate", action="store_true")
    ap.add_argument("--no-e0", action="store_true")
    args = ap.parse_args(argv)
    with (rounded_f32_factors() if args.rounded_f32
          else contextlib.nullcontext()):
        return _run(args)


def _run(args):
    build = MODELS[args.model]
    case = {"model": args.model, "size": args.size, "tol": args.tol,
            "factor_dtype": args.factor_dtype,
            "rounded_f32": args.rounded_f32,
            "certificate": args.certificate}
    opts = dict(tol=args.tol, factor_dtype=args.factor_dtype,
                max_iter=args.max_iter)
    if args.certificate:
        build = _pandemic_elastic
        opts.update(CERTIFICATE)

    jax_run = _solve(lambda **kw: JBackend(_JaxReturns, **kw), jmodels,
                     build, args.size, print_level=0, **opts)
    chunks = _JaxReturns.chunks
    jax_run.update(host_returns=[c[2] for c in chunks],
                   f32_until=_f32_until(chunks),
                   f32_steps=_f32_steps(chunks),
                   lsq_recalcs=list(_JaxReturns.lsq))
    print(json.dumps({**case, "jax": jax_run}), flush=True)
    port_backend = []

    def port(**kw):
        port_backend.append(ExaTranscriptionBackend(_PortE0, device="cpu",
                                                    **kw))
        return port_backend[0]
    port_run = _solve(port, tmodels, build, args.size, print_level=0,
                      **opts)
    port_run.update(host_returns=port_backend[0].solver.host_returns,
                    f32_until=_f32_until(_PortE0.steps),
                    f32_steps=sum(1 for st in _PortE0.steps if st[0]),
                    lsq_recalcs=list(_PortE0.lsq))
    print(json.dumps({**case, "port": port_run}), flush=True)
    if args.no_e0:
        return 0

    with contextlib.redirect_stdout(io.StringIO()):
        _solve(lambda **kw: JBackend(_JaxE0, **kw), jmodels, build,
               args.size, print_level=5, **opts)
    je, te = _JaxE0.e0, _PortE0.e0
    rel = [abs(a - b) / max(abs(a), 1e-300) for a, b in zip(je, te)]
    first = next((i + 1 for i, r in enumerate(rel) if r > 1e-9), None)
    print(json.dumps({**case, "e0": {
        "first_iteration_rel_gt_1e-9": first, "rel": rel, "jax": je,
        "port": te}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
