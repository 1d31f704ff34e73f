"""Where the time goes in one solve on the CUDA card.

    python -m infiniteexamodels_jl_torch.tools.profile [--model MODEL]
        [--size 1000] [--factor-dtype float64|mixed|float32|ir32]
        [--max-iter N] [--certificate] [--first-only] [--no-trajectory]

``--model`` is one of quad, opf, hovercraft, kinetics, design_3node and
pandemic; ``--size`` the supports (quad, hovercraft, kinetics), the
scenarios (opf, design_3node) or, for pandemic, ``NT,NXI`` (supports,
scenarios); ``--factor-dtype`` the IPM's step set (the f32 ones add their
phases to ``phases`` and where each run's f32 steps ended to
``trajectory``).  ``--certificate`` solves pandemic as the reference's
(100,32) certificate does: the elastic cap (rho 500), the least-squares
dual start and the stall-triggered dual recalc, max_iter 900.
``--first-only`` stops after ``first_solve`` and ``phases_ms``;
``--no-trajectory`` leaves out ``trajectory`` (its host-CPU and plain-K1
solves), for solves of hundreds of iterations.

Prints one JSON object per line:

- the card's name and power limit;
- ``phases``: wall milliseconds of each IPM step phase at the initial point
  (``IpmSolver.profile_phases``);
- ``first_solve``: the first solve's status, iterations, objective, primal
  and dual feasibility, wall time, the KKT's mode and shape, and K1's
  launches per factorization;
- ``solve``: a warm re-solve's wall time, iterations and per-iteration time;
- ``profiler``: ``torch.profiler`` over one more warm re-solve, cut at
  ``PROFILE_ITERS`` iterations (a pandemic endgame of hundreds of
  iterations makes a trace too large to summarize) -- the summed
  device time of all kernels against the wall time (the device's busy
  share), the number of kernel launches, K1's device time (every kernel
  whose name contains ``chol_linv``: ``chol_linv_smem_kernel`` and
  ``chol_linv_cluster_kernel``), and the top kernels by device time;
- ``trajectory``: the same solve through the port on the host CPU, and on
  the card with K1 swapped for its plain version (``chol_linv_reference``,
  i.e. cuSOLVER/cuBLAS) for this one comparison; for each, the iteration
  count and the first iteration whose scaled KKT error E0 differs from the
  K1 run's by more than 1e-9 relative, and (``f32_until``) the iteration
  and status of each run's last f32 step.

Exits non-zero when CUDA is absent.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from ..backend import ExaTranscriptionBackend
from .. import models
from ..solvers import IpmSolver, block_tridiag
from ..solvers.chol_linv import chol_linv, chol_linv_reference


class _TracedIpm(IpmSolver):
    """IpmSolver that records the scaled KKT error E0 of every step, and
    (iteration, status) after its f32 steps."""

    def solve(self, *args, **kwargs):
        self.e0, self.f32 = [], []
        return super().solve(*args, **kwargs)

    def _step(self, st, consts, kkt=None):
        st = super()._step(st, consts, kkt)
        self.e0.append(float(st.log_E0))
        if kkt is not None and kkt is self.kkt32:
            self.f32.append((int(st.iter), int(st.status)))
        return st


def _pandemic(size, certificate=False):
    nt, nxi = (int(v) for v in str(size).split(","))
    kw = dict(elastic_rho=500.0) if certificate else {}
    return models.pandemic(num_supports=nt, num_scenarios=nxi, **kw)


MODELS = {
    "quad": lambda size, _: models.quad(num_supports=int(size)),
    "opf": lambda size, _: models.opf(num_supports=int(size)),
    "hovercraft": lambda size, _: models.hovercraft(num_supports=int(size)),
    "kinetics": lambda size, _: models.kinetic_control(
        num_supports=int(size)),
    "design_3node": lambda size, _: models.design_3node(
        num_scenarios=int(size)),
    "pandemic": _pandemic,
}
# the solver options of the reference's pandemic (100,32) certificate
# (its slow test test_pandemic_stall_recalc_100x32)
CERTIFICATE = dict(max_iter=900, dual_init="lsq", recalc_y_stall=True)
PROFILE_ITERS = 30      # iterations of the profiled re-solve, at most


def _solve(args, device):
    m = MODELS[args.model](args.size, args.certificate)
    opts = dict(CERTIFICATE) if args.certificate else {}
    if args.max_iter is not None:
        opts["max_iter"] = args.max_iter
    b = ExaTranscriptionBackend(_TracedIpm, device=device,
                                linear_solver="auto", tol=1e-6,
                                factor_dtype=args.factor_dtype,
                                print_level=0, **opts)
    m.set_transformation_backend(b)
    b.build(m)
    res = b.optimize(m)
    return m, b, res


def device_us(evt):
    """An event's own device microseconds (the attribute's name differs
    between torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="quad")
    ap.add_argument("--size", default="1000")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--certificate", action="store_true")
    ap.add_argument("--first-only", action="store_true")
    ap.add_argument("--trajectory", default=True,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--factor-dtype", default="float64",
                    choices=("float64", "mixed", "float32", "ir32"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "model": args.model, "size": args.size,
                      "factor_dtype": args.factor_dtype}))

    chol_linv.launches = 0
    t0 = time.perf_counter()
    m, b, res = _solve(args, "cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    kkt = b.solver.kkt
    first = {"status": res.status, "iterations": res.iter,
             "objective": res.objective, "primal_feas": res.primal_feas,
             "dual_feas": res.dual_feas, "wall_s": first_s,
             "kkt": type(kkt).__name__}
    if isinstance(kkt, block_tridiag.BlockTridiagKKT):
        first.update(mode=kkt.mode, nb=kkt.nb, bs=kkt.bs, mB=kkt.mB,
                     factorizations=kkt.factorizations,
                     k1_launches=chol_linv.launches,
                     k1_launches_per_factorization=(
                         chol_linv.launches / max(kkt.factorizations, 1)))
    print(json.dumps({"first_solve": first}))
    e0_card, f32_card = list(b.solver.e0), list(b.solver.f32)
    phases = b.solver.profile_phases()
    print(json.dumps({"phases_ms": {k: 1e3 * v for k, v in phases.items()}}))
    if args.first_only:
        return 0

    t0 = time.perf_counter()
    res = b.optimize(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps({"solve": {"status": res.status, "iterations": res.iter,
                                "objective": res.objective, "wall_s": wall,
                                "ms_per_iteration": 1e3 * wall / res.iter}}))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n_prof = min(res.iter, PROFILE_ITERS)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        b.solver.solve(max_iter=n_prof)
        torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if device_us(e) > 0]
    dev_us = sum(device_us(e) for e in events)
    launches = sum(e.count for e in events)
    k1_us = sum(device_us(e) for e in events if "chol_linv" in e.key)
    top = sorted(events, key=device_us, reverse=True)[:args.top]
    print(json.dumps({"profiler": {
        "iterations": n_prof, "wall_s": wall_prof,
        "device_busy_s": dev_us / 1e6,
        "device_busy_share": dev_us / 1e6 / wall_prof,
        "device_ops_with_time": launches,
        "k1_device_s": k1_us / 1e6,
        "top": [{"name": e.key[:80], "count": e.count,
                 "device_ms": device_us(e) / 1e3} for e in top]}}))

    if not args.trajectory:
        return 0

    def against_card(solver, res):
        e0 = solver.e0
        rel = [abs(a - c) / max(abs(c), 1e-300) for a, c in zip(e0_card, e0)]
        return {"iterations": res.iter, "status": res.status,
                "objective": res.objective,
                "f32_until": solver.f32[-1] if solver.f32 else None,
                "first_iteration_e0_rel_gt_1e-9": next(
                    (i for i, r in enumerate(rel) if r > 1e-9), None),
                "e0_rel_diff": rel, "e0": list(e0)}

    _, bc, rc = _solve(args, "cpu")
    cpu = against_card(bc.solver, rc)
    k1 = block_tridiag._chol_linv
    block_tridiag._chol_linv = lambda D: chol_linv_reference(D.contiguous())
    try:
        _, bp, rp = _solve(args, "cuda")
    finally:
        block_tridiag._chol_linv = k1
    plain = against_card(bp.solver, rp)
    print(json.dumps({"trajectory": {
        "card_k1": {"iterations": res.iter, "e0": e0_card,
                    "f32_until": f32_card[-1] if f32_card else None},
        "host_cpu": cpu, "card_plain_chol_linv": plain}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
