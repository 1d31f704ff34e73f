"""The low-precision step sets of both packages from the same states, on the
host CPU.

    python -m tests.torch_vs_jax_f32 --model quad --size 12 --tol 1e-8 \
        --factor-dtype mixed --factor-at 2
    python -m tests.torch_vs_jax_f32 --model quad --size 1000 \
        --factor-dtype ir32 --factor-at 11

The JAX package takes its f32 step set's steps (``factor_dtype`` "mixed",
"float32" or "ir32", ``linear_solver="auto"``) one at a time from its
initial point until a step leaves RUNNING (a demotion, or the end); from
each of its states the port takes one step in the same step set.  Prints
one JSON object per step: the JAX package's and the port's status,
regularization ``delta_w``, refinement residual ``rr``, line-search trials
and step length, and the normwise relative difference of the two new x
(over the JAX step's change of x).

With ``--factor-at K`` the K-th step is taken once more in each package
with both ``_chol_linv`` calls recorded (the JAX package's jit off for it):
for every f32 factorization of the step's last regularization attempt, per
BCR level, the largest difference of the packages' input blocks, the blocks
each rejected, their least pivot ``L_jj^2 / D_jj`` in epsilons, the
normwise difference of the two L^{-1}, and the distance of each from the
exact L^{-1} of the same f32 blocks (computed in f64) where the level is
small enough for that; and the condition number of each block of the
first level.
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")

from infiniteexamodels_jl_tpu import models as jmodels  # noqa: E402
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver  # noqa: E402
from infiniteexamodels_jl_tpu.solvers import (  # noqa: E402
    block_tridiag as jblock)
from infiniteexamodels_jl_tpu.solvers.ipm import (  # noqa: E402
    RUNNING as JRUNNING, IpmState as JIpmState)
from infiniteexamodels_jl_tpu.transcribe import (  # noqa: E402
    transcribe as jtranscribe)
from infiniteexamodels_jl_torch import models as tmodels  # noqa: E402
from infiniteexamodels_jl_torch.interop import (  # noqa: E402
    state_from_numpy, state_to_numpy)
from infiniteexamodels_jl_torch.solvers import IpmSolver  # noqa: E402
from infiniteexamodels_jl_torch.solvers import (  # noqa: E402
    block_tridiag as tblock)
from infiniteexamodels_jl_torch.transcribe import (  # noqa: E402
    transcribe as ttranscribe)

from tests.torch_vs_jax_trajectory import MODELS  # noqa: E402

FIELDS = ("status", "log_delta_w", "log_rr", "log_ls", "log_alpha")
EPS32 = float(np.finfo(np.float32).eps)


def _numpy(st):
    return {k: np.array(v) for k, v in st._asdict().items()}


def _least_pivots(D, L):
    """Per block, min_j L_jj^2 / D_jj in f32 epsilons (NaN if L is)."""
    piv = np.einsum("bii->bi", L).astype(np.float64) ** 2
    return (piv / np.einsum("bii->bi", D).astype(np.float64)).min(1) / EPS32


def _factor_record(level, jrec, trec):
    (Dj, _, Xj), (Dt, Lt, Xt) = jrec, trec
    Lj = jrec[1]
    fin = np.isfinite(Xj) & np.isfinite(Xt)
    scale = np.abs(Xj[fin]).max() if fin.any() else 1.0
    rec = {"level": level, "shape": list(Dj.shape),
           "input_max_diff": float(np.abs(Dj - Dt).max()
                                   / max(np.abs(Dj).max(), 1e-300)),
           "rejected": [int((~np.isfinite(Lj).reshape(len(Lj), -1)
                             .all(1)).sum()),
                        int((~np.isfinite(Lt).reshape(len(Lt), -1)
                             .all(1)).sum())],
           "least_pivot_eps": [float(np.nanmin(_least_pivots(Dj, Lj))),
                               float(np.nanmin(_least_pivots(Dt, Lt)))],
           "linv_diff": float(np.abs(Xj - Xt)[fin].max() / scale)
           if fin.any() else None}
    if Dj.shape[0] <= 8 or level == 0:
        D64 = Dj.astype(np.float64)
        try:
            Xe = np.linalg.inv(np.linalg.cholesky(D64))
            se = np.abs(Xe).max(axis=(1, 2))
            rec["linv_from_exact"] = [
                float((np.abs(X - Xe).max(axis=(1, 2)) / se).max())
                for X in (Xj, Xt)]
        except np.linalg.LinAlgError:
            rec["linv_from_exact"] = None
        if level == 0:
            rec["block_cond"] = [float(c) for c in np.linalg.cond(D64)]
    return rec


def _factors_at(js, consts, ts, tc, cur):
    """One step of each package from ``cur`` with K1's calls recorded;
    returns the f32 calls of the last regularization attempt in each."""
    jcalls, tcalls = [], []
    jchol, tchol = jblock._chol_linv, tblock._chol_linv

    def jrec(D):
        out = jchol(D)
        try:
            jcalls.append(tuple(np.array(a) for a in (D, out[0], out[1])))
        except jax.errors.TracerArrayConversionError:
            pass                      # the shape-only trace of the ladder
        return out

    def trec(D):
        out = tchol(D)
        tcalls.append(tuple(a.detach().numpy().copy()
                            for a in (D, out[0], out[1])))
        return out

    jblock._chol_linv, tblock._chol_linv = jrec, trec
    try:
        with jax.disable_jit():
            js._stepw(JIpmState(**{k: jnp.asarray(v)
                                   for k, v in cur.items()}),
                      consts, js.kkt32)
        ts._step(state_from_numpy(cur, "cpu"), tc, ts.kkt32)
    finally:
        jblock._chol_linv, tblock._chol_linv = jchol, tchol
    levels = ts.kkt.k1_launches_per_factorization()
    return [c for c in jcalls if c[0].dtype == np.float32][-levels:], \
        [c for c in tcalls if c[0].dtype == np.float32][-levels:]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="quad")
    ap.add_argument("--size", default="12")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--factor-dtype", default="mixed",
                    choices=("mixed", "float32", "ir32"))
    ap.add_argument("--factor-at", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=200)
    args = ap.parse_args(argv)
    build = MODELS[args.model]
    opts = dict(linear_solver="auto", print_level=0, tol=args.tol,
                factor_dtype=args.factor_dtype)
    jm, _ = jtranscribe(build(jmodels, args.size))
    tm, _ = ttranscribe(build(tmodels, args.size), device="cpu")
    js = JIpmSolver(jm, **opts)
    consts = dict(js._compute_consts(jm.theta, jm))
    consts["fam"] = jm.fam_tables()
    consts["jac_rows"] = jm.jac_rows
    consts["jac_cols"] = jm.jac_cols
    ts = IpmSolver(tm, **opts)
    tc = ts._compute_consts(tm.theta, tm)
    y0s = jm.y0 * jm.sense * consts["sf"] / consts["sc"]
    st = js._init_jit(jm.x0, y0s, consts)
    for k in range(1, args.max_steps + 1):
        cur = _numpy(st)
        if k == args.factor_at:
            jf, tf = _factors_at(js, consts, ts, tc, cur)
            for i, (a, b) in enumerate(zip(jf, tf)):
                print(json.dumps({"step": k, "factor": _factor_record(
                    i, a, b)}), flush=True)
        port = state_to_numpy(ts._step(state_from_numpy(cur, "cpu"), tc,
                                       ts.kkt32))
        st = js._step32_jit(st, consts)
        want = _numpy(st)
        moved = np.abs(want["x"] - cur["x"]).max()
        print(json.dumps({
            "step": k, "iter": int(want["iter"]),
            **{f: [float(want[f]), float(port[f])] for f in FIELDS},
            "x_diff": float(np.abs(want["x"] - port["x"]).max() / moved)
            if moved > 0 else 0.0}), flush=True)
        if int(want["status"]) != JRUNNING:
            break
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
