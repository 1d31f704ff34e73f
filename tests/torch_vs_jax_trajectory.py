"""The port against the JAX package on the host CPU, one model at one size.

    python -m tests.torch_vs_jax_trajectory --model opf --size 1000

Both packages solve the same model through ``ExaTranscriptionBackend(
IpmSolver, linear_solver="auto", tol=1e-6)``; ``--size`` is the OPF's
scenarios, the farmer's scenarios or the quadrotor's supports.  Prints one
JSON object per line:

- ``jax`` and ``port``: status, iterations, objective and wall seconds of
  each solve (the JAX time includes its compile);
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

MODELS = {
    "opf": lambda M, n: M.opf(num_supports=n),
    "farmer": lambda M, n: M.farmer(num_scenarios=n),
    "quad": lambda M, n: M.quad(num_supports=n),
}


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

    def _step(self, st, consts, kkt=None):
        st = super()._step(st, consts, kkt)
        _PortE0.e0.append(float(st.log_E0))
        return st


def _solve(backend, M, build, size, **kw):
    m = build(M, size)
    b = backend(linear_solver="auto", tol=1e-6, **kw)
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
    args = ap.parse_args(argv)
    build = MODELS[args.model]
    case = {"model": args.model, "size": args.size}

    jax_run = _solve(lambda **kw: JBackend(JIpmSolver, **kw), jmodels, build,
                     args.size, print_level=0)
    print(json.dumps({**case, "jax": jax_run}), flush=True)
    port_run = _solve(lambda **kw: ExaTranscriptionBackend(
        _PortE0, device="cpu", **kw), tmodels, build, args.size,
        print_level=0)
    print(json.dumps({**case, "port": port_run}), flush=True)

    with contextlib.redirect_stdout(io.StringIO()):
        _solve(lambda **kw: JBackend(_JaxE0, **kw), jmodels, build,
               args.size, print_level=5)
    je, te = _JaxE0.e0, _PortE0.e0
    rel = [abs(a - b) / max(abs(a), 1e-300) for a, b in zip(je, te)]
    first = next((i + 1 for i, r in enumerate(rel) if r > 1e-9), None)
    print(json.dumps({**case, "e0": {
        "first_iteration_rel_gt_1e-9": first, "rel": rel, "jax": je,
        "port": te}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
