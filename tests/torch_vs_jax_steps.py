"""One port step from every state of the JAX package's solve, on the host CPU.

    python -m tests.torch_vs_jax_steps --model pandemic --size 100,8 \
        --max-iter 600
    python -m tests.torch_vs_jax_steps --model pandemic --size 100,8 \
        --max-iter 600 --from 300
    python -m tests.torch_vs_jax_steps --model pandemic --size 100,32 \
        --certificate --from 250 --until 360
    python -m tests.torch_vs_jax_steps --model kinetics --size 50 \
        --jax-dense
    python -m tests.torch_vs_jax_steps --model pandemic --size 100,32 \
        --certificate --from 200 --until 260 --jax-ldl

The JAX package solves the model (``linear_solver="auto"``, tol 1e-6 unless
``--tol``; ``--certificate``: the (100,32) certificate's model and options,
as in tests/torch_vs_jax_trajectory.py) as its host loop does: device
chunks of 32 steps, and at each return to the host the feasibility
restoration, the stall-triggered least-squares dual recalc and the stop
(``_solve_impl``, replayed here one step at a time with the package's own
jitted step, restoration and recalc).  From each of its states from
iteration ``--from`` on the port takes one step (band KKT), and the result
is held against the JAX package's next state.  Prints one JSON object per
iteration:

- ``bookkeeping``: the fields of the endgame's bookkeeping (status, the
  near-optimal visit count, the best iterate's KKT error and objective, the
  best feasible objective) and of the step's discrete choices (backtracks,
  regularization) where the port's differ from the JAX package's by more
  than 1e-9 relative, as ``[jax, port]``; the JAX package's values of the
  visit count and status;
- ``direction``: the normwise relative difference of the iterate's parts
  (x, s, y, zl, zu) and of the stored best iterate (best_x, best_y)
  between the port's step and the JAX package's;
- with ``--jax-dense``, ``jax_dense``: the same difference between the JAX
  package's own dense-KKT step from the same state and its band step (the
  spread of the reference's two exact routes); with ``--jax-ldl``,
  ``jax_ldl``: the same for the JAX package's step through its host sparse
  LDL (``linear_solver="ldl_cpp"``), for models too large for the dense
  route.

and one per return to the host (``host_return``): the status code, and

- ``gate``: the recalc gate's four conditions (the objective stalled
  against the previous return's, pr <= 1e2 tol, du > 1e4 tol, alpha <=
  0.25) and ``prev_chunk_obj``, from the JAX state and from the port's last
  step (from the same JAX state, with the same previous objective), and
  whether each would fire; where the JAX package fires, ``lsq_y``: the
  normwise difference of the two packages' least-squares duals from the
  same state;
- at a restoration, ``restore``: the normwise difference of the two
  packages' ``_restore`` from the same state (x, s, zl, zu, mu).

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
    NEED_RESTORATION as JNEED_RESTORATION, RUNNING as JRUNNING,
    IpmState as JIpmState, _kkt_tables)
from infiniteexamodels_jl_tpu.transcribe import (  # noqa: E402
    transcribe as jtranscribe)
from infiniteexamodels_jl_torch import models as tmodels  # noqa: E402
from infiniteexamodels_jl_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from infiniteexamodels_jl_torch.solvers import IpmSolver  # noqa: E402
from infiniteexamodels_jl_torch.transcribe import (  # noqa: E402
    transcribe as ttranscribe)

from tests.torch_vs_jax_trajectory import (  # noqa: E402
    CERTIFICATE, MODELS, _pandemic_elastic)

BOOKKEEPING = ("status", "acc_visits", "best_E", "best_fobj", "feas_fobj",
               "log_ls", "log_delta_w")
DIRECTION = ("x", "s", "y", "zl", "zu", "best_x", "best_y")
RESTORED = ("x", "s", "zl", "zu", "mu")
HOST_CHUNK = 32


def _jax_solver(jm, linear_solver, tol, **opts):
    js = JIpmSolver(jm, linear_solver=linear_solver, print_level=0, tol=tol,
                    **opts)
    consts = dict(js._compute_consts(jm.theta, jm))
    consts["fam"] = jm.fam_tables()
    consts["jac_rows"] = jm.jac_rows
    consts["jac_cols"] = jm.jac_cols
    return js, consts


def _numpy(st):
    return {k: np.array(v) for k, v in st._asdict().items()}


def _jax_state(d):
    return JIpmState(**{k: jnp.asarray(v) for k, v in d.items()})


def _normwise(a, b):
    a, b = np.atleast_1d(a), np.atleast_1d(b)
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


def gate(st, prev_obj, tol):
    """The stall-triggered recalc's conditions at a host return, as both
    packages' host loops evaluate them (JAX ipm.py ``_solve_impl``): the
    objective stalled against ``prev_obj``, pr <= 1e2 tol, du > 1e4 tol,
    alpha <= 0.25; returns (conditions, fire, the objective to carry).
    ``fire`` is the last three (``recalc_y_obj_gate`` off, as in the
    certificate)."""
    obj = float(st["log_obj"])
    stalled = (prev_obj is not None
               and obj >= prev_obj - 1e-5 * max(1.0, abs(obj)))
    conds = [bool(stalled), float(st["log_inf_pr"]) <= 1e2 * tol,
             float(st["log_inf_du"]) > 1e4 * tol,
             float(st["log_alpha"]) <= 0.25]
    return conds, all(conds[1:]), obj


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="pandemic")
    ap.add_argument("--size", default="100,8")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iter", type=int, default=600)
    ap.add_argument("--from", dest="start", type=int, default=0)
    ap.add_argument("--until", type=int, default=None)
    ap.add_argument("--certificate", action="store_true")
    route = ap.add_mutually_exclusive_group()
    route.add_argument("--jax-dense", action="store_true")
    route.add_argument("--jax-ldl", action="store_true")
    args = ap.parse_args(argv)
    build = MODELS[args.model]
    opts = {}
    if args.certificate:
        build = _pandemic_elastic
        opts = dict(CERTIFICATE)
        if args.max_iter != ap.get_default("max_iter"):
            opts["max_iter"] = args.max_iter
    max_iter = opts.get("max_iter", args.max_iter)
    until = max_iter if args.until is None else args.until
    jm, _ = jtranscribe(build(jmodels, args.size))
    js, consts = _jax_solver(jm, "auto", args.tol, **opts)
    jd = None
    if args.jax_dense or args.jax_ldl:
        key = "jax_dense" if args.jax_dense else "jax_ldl"
        jd = _jax_solver(jm, "dense" if args.jax_dense else "ldl_cpp",
                         args.tol, **opts)
    tm, _ = ttranscribe(build(tmodels, args.size), device="cpu")
    ts = IpmSolver(tm, linear_solver="auto", print_level=0, tol=args.tol,
                   **opts)
    tc = ts._compute_consts(tm.theta, tm)
    tol = float(consts["tol"])
    lsq = js._ensure_lsq_jit()

    def restw(s, c):
        with js.model.bound_tables(c.get("fam"), c.get("jac_rows"),
                                   c.get("jac_cols")), \
                _kkt_tables(js.kkt, c.get("kkt")):
            return js._restore(s, c)
    jrestore = jax.jit(restw)

    y0s = jm.y0 * jm.sense * consts["sf"] / consts["sc"]
    st = js._init_jit(jm.x0, y0s, consts)
    if js.opts["dual_init"] == "lsq":
        y = lsq(st, consts)
        st = st._replace(y=y, best_y=jnp.array(y, copy=True))
    it, chunk_end, prev_obj = 0, min(HOST_CHUNK, max_iter), None
    resto_entries = 0
    port_last = None
    stall = js.opts["recalc_y_stall"]
    while it < max_iter and it < until:
        # one device chunk of the JAX host loop, a step at a time
        while int(st.status) == JRUNNING and int(st.iter) < chunk_end:
            cur = _numpy(st)
            port = None
            if int(cur["iter"]) >= args.start:
                port = state_to_numpy(ts._step(state_from_numpy(cur, "cpu"),
                                               tc))
            dense = None
            if jd is not None and port is not None:
                dense = _numpy(jd[0]._step_jit(_jax_state(cur), jd[1]))
            st = js._step_jit(st, consts)      # donates st: copied above
            port_last = port
            if port is None:
                continue
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
                rec[key] = {f: _normwise(dense[f], want[f])
                            for f in DIRECTION}
            print(json.dumps(rec), flush=True)
        # the return to the host
        code, it = int(st.status), int(st.iter)
        rec = {"host_return": it, "code": code}
        if code == JNEED_RESTORATION and \
                resto_entries < js.opts["resto_max_entries"]:
            resto_entries += 1
            cur = _numpy(st)
            port = state_to_numpy(ts._restore(state_from_numpy(cur, "cpu"),
                                               tc))
            st = jrestore(st, consts)
            want = _numpy(st)
            rec["restore"] = {f: _normwise(port[f], want[f])
                              for f in RESTORED}
            print(json.dumps(rec), flush=True)
            chunk_end = min(it + HOST_CHUNK, max_iter)
            continue
        if code == JRUNNING and stall:
            cur = _numpy(st)
            conds, fire, obj = gate(cur, prev_obj, tol)
            rec["gate"] = {"prev_chunk_obj": prev_obj, "jax": conds,
                           "jax_fires": fire}
            if port_last is not None:
                pconds, pfire, _ = gate(port_last, prev_obj, tol)
                rec["gate"].update(port=pconds, port_fires=pfire)
            prev_obj = obj
            if fire:
                py = ts._lsq_duals(state_from_numpy(cur, "cpu"), tc)
                y = lsq(st, consts)
                rec["lsq_y"] = _normwise(py.numpy(), np.asarray(y))
                st = st._replace(y=y)
        print(json.dumps(rec), flush=True)
        if code != JRUNNING:
            break
        chunk_end = min(it + HOST_CHUNK, max_iter)
    print(json.dumps({"jax_end": {"status": int(st.status),
                                  "iter": int(st.iter),
                                  "best_E": float(st.best_E)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
