"""One port step from every state of the JAX package's solve, on the host CPU.

    python -m tests.torch_vs_jax_steps --model pandemic --size 100,8 \
        --max-iter 600
    python -m tests.torch_vs_jax_steps --model kinetics --size 50 \
        --jax-dense

The JAX package solves the model (``linear_solver="auto"``, tol 1e-6 unless
``--tol``) one step at a time, as its host loop does; from each of its
states the port takes one step (band KKT), and the result is held against
the JAX package's next state.  Prints one JSON object per iteration:

- ``bookkeeping``: the fields of the endgame's bookkeeping (status, the
  near-optimal visit count, the best iterate's KKT error and objective, the
  best feasible objective) and of the step's discrete choices (backtracks,
  regularization) where the port's differ from the JAX package's by more
  than 1e-9 relative, as ``[jax, port]``; the JAX package's values of the
  visit count and status;
- ``direction``: the normwise relative difference of the iterate's parts
  (x, s, y, zl, zu) between the port's step and the JAX package's;
- with ``--jax-dense``, ``jax_dense``: the same difference between the JAX
  package's own dense-KKT step from the same state and its band step (the
  spread of the reference's two exact routes).

The last line is the JAX solve's end: status code, iteration, best KKT
error.  Every model of tests/torch_vs_jax_trajectory.py is available.
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

from infiniteexamodels_jl_tpu import models as jmodels  # noqa: E402
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver  # noqa: E402
from infiniteexamodels_jl_tpu.solvers.ipm import (  # noqa: E402
    RUNNING as JRUNNING, IpmState as JIpmState)
from infiniteexamodels_jl_tpu.transcribe import (  # noqa: E402
    transcribe as jtranscribe)
from infiniteexamodels_jl_torch import models as tmodels  # noqa: E402
from infiniteexamodels_jl_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from infiniteexamodels_jl_torch.solvers import IpmSolver  # noqa: E402
from infiniteexamodels_jl_torch.transcribe import (  # noqa: E402
    transcribe as ttranscribe)

from tests.torch_vs_jax_trajectory import MODELS  # noqa: E402

BOOKKEEPING = ("status", "acc_visits", "best_E", "best_fobj", "feas_fobj",
               "log_ls", "log_delta_w")
DIRECTION = ("x", "s", "y", "zl", "zu")


def _jax_solver(jm, linear_solver, tol):
    js = JIpmSolver(jm, linear_solver=linear_solver, print_level=0, tol=tol)
    consts = dict(js._compute_consts(jm.theta, jm))
    consts["fam"] = jm.fam_tables()
    consts["jac_rows"] = jm.jac_rows
    consts["jac_cols"] = jm.jac_cols
    return js, consts


def _numpy(st):
    return {k: np.array(v) for k, v in st._asdict().items()}


def _normwise(a, b):
    fin = np.isfinite(b) & np.isfinite(a)
    if not fin.any():
        return 0.0
    scale = np.abs(b[fin]).max()
    diff = np.abs(a[fin] - b[fin]).max()
    return float(diff / scale) if scale > 0 else float(diff)


def _differs(a, b):
    a, b = float(a), float(b)
    if a == b:
        return False
    return abs(a - b) > 1e-9 * max(abs(b), 1e-300)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="pandemic")
    ap.add_argument("--size", default="100,8")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iter", type=int, default=600)
    ap.add_argument("--jax-dense", action="store_true")
    args = ap.parse_args(argv)
    build = MODELS[args.model]
    jm, _ = jtranscribe(build(jmodels, args.size))
    js, consts = _jax_solver(jm, "auto", args.tol)
    jd = _jax_solver(jm, "dense", args.tol) if args.jax_dense else None
    tm, _ = ttranscribe(build(tmodels, args.size), device="cpu")
    ts = IpmSolver(tm, linear_solver="auto", print_level=0, tol=args.tol)
    tc = ts._compute_consts(tm.theta, tm)
    y0s = jm.y0 * jm.sense * consts["sf"] / consts["sc"]
    st = js._init_jit(jm.x0, y0s, consts)
    while int(st.status) == JRUNNING and int(st.iter) < args.max_iter:
        cur = _numpy(st)
        port = state_to_numpy(ts._step(state_from_numpy(cur, "cpu"), tc))
        dense = None
        if jd is not None:
            s0 = JIpmState(**{k: jnp.asarray(v) for k, v in cur.items()})
            dense = _numpy(jd[0]._step_jit(s0, jd[1]))
        st = js._step_jit(st, consts)      # donates st: copied out above
        want = _numpy(st)
        rec = {"iter": int(want["iter"]),
               "acc_visits": int(want["acc_visits"]),
               "status": int(want["status"]),
               "bookkeeping": {f: [float(want[f]), float(port[f])]
                               for f in BOOKKEEPING
                               if _differs(port[f], want[f])},
               "direction": {f: _normwise(port[f], want[f])
                             for f in DIRECTION}}
        if dense is not None:
            rec["jax_dense"] = {f: _normwise(dense[f], want[f])
                                for f in DIRECTION}
        print(json.dumps(rec), flush=True)
    print(json.dumps({"jax_end": {"status": int(st.status),
                                  "iter": int(st.iter),
                                  "best_E": float(st.best_E)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
