"""The port against the JAX package on the host CPU, one model at one size.

    python -m tests.torch_vs_jax_trajectory --model opf --size 1000
    python -m tests.torch_vs_jax_trajectory --model quad --size 1000 \
        --factor-dtype mixed

Both packages solve the same model through ``ExaTranscriptionBackend(
IpmSolver, linear_solver="auto", tol=1e-6)`` (``--tol`` and
``--factor-dtype`` change those options); ``--size`` is the OPF's
scenarios, the farmer's scenarios or the quadrotor's supports.  Prints one
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

The JAX package records E0 through its one-step-per-round-trip loop
(``print_level=5``, whose log goes to a discarded buffer); with the default
options that loop takes the same steps as its 32-step device chunks.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

from infiniteexamodels_jl_tpu import models as jmodels  # noqa: E402
from infiniteexamodels_jl_tpu.backend import (  # noqa: E402
    ExaTranscriptionBackend as JBackend)
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver  # noqa: E402
from infiniteexamodels_jl_torch import models as tmodels  # noqa: E402
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend  # noqa: E402
from infiniteexamodels_jl_torch.solvers import IpmSolver  # noqa: E402
from infiniteexamodels_jl_torch.solvers.ipm import DEMOTE_F32  # noqa: E402

MODELS = {
    "opf": lambda M, n: M.opf(num_supports=n),
    "farmer": lambda M, n: M.farmer(num_scenarios=n),
    "quad": lambda M, n: M.quad(num_supports=n),
}


class _JaxReturns(JIpmSolver):
    """Records every device chunk's return: (f32?, status code, iter)."""
    chunks = []

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

    def _step(self, st, consts, kkt=None):
        st = super()._step(st, consts, kkt)
        _PortE0.e0.append(float(st.log_E0))
        _PortE0.steps.append((kkt is not None and kkt is self.kkt32,
                              int(st.status), int(st.iter)))
        return st


def _solve(backend, M, build, size, **kw):
    m = build(M, size)
    b = backend(linear_solver="auto", **kw)
    m.set_transformation_backend(b)
    t0 = time.time()
    b.build(m)
    res = b.optimize(m)
    return {"status": res.status, "iterations": res.iter,
            "objective": res.objective, "wall_s": time.time() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="opf")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--factor-dtype", default="float64",
                    choices=("float64", "mixed", "float32", "ir32"))
    args = ap.parse_args(argv)
    build = MODELS[args.model]
    case = {"model": args.model, "size": args.size, "tol": args.tol,
            "factor_dtype": args.factor_dtype}
    opts = dict(tol=args.tol, factor_dtype=args.factor_dtype)

    jax_run = _solve(lambda **kw: JBackend(_JaxReturns, **kw), jmodels,
                     build, args.size, print_level=0, **opts)
    chunks = _JaxReturns.chunks
    jax_run.update(host_returns=[c[2] for c in chunks],
                   f32_until=_f32_until(chunks))
    print(json.dumps({**case, "jax": jax_run}), flush=True)
    port_backend = []

    def port(**kw):
        port_backend.append(ExaTranscriptionBackend(_PortE0, device="cpu",
                                                    **kw))
        return port_backend[0]
    port_run = _solve(port, tmodels, build, args.size, print_level=0,
                      **opts)
    port_run.update(host_returns=port_backend[0].solver.host_returns,
                    f32_until=_f32_until(_PortE0.steps))
    print(json.dumps({**case, "port": port_run}), flush=True)

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
