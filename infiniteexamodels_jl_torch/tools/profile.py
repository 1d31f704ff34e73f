"""Where the time goes in one solve on the CUDA card.

    python -m infiniteexamodels_jl_torch.tools.profile [--model quad|opf]
        [--size 1000] [--factor-dtype float64|mixed|float32|ir32]

``--size`` is the quadrotor's supports or the OPF's scenarios;
``--factor-dtype`` the IPM's step set (the f32 ones add their phases to
``phases`` and where each run's f32 steps ended to ``trajectory``).

Prints one JSON object per line:

- the card's name and power limit;
- ``phases``: wall milliseconds of each IPM step phase at the initial point
  (``IpmSolver.profile_phases``);
- ``solve``: a warm re-solve's wall time, iterations and per-iteration time;
- ``profiler``: ``torch.profiler`` over one more warm re-solve -- the summed
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
from ..models import opf, quad
from ..solvers import IpmSolver, block_tridiag
from ..solvers.chol_linv import chol_linv_reference


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


MODELS = {"quad": quad, "opf": opf}


def _solve(model, size, device, factor_dtype):
    m = MODELS[model](num_supports=size)
    b = ExaTranscriptionBackend(_TracedIpm, device=device,
                                linear_solver="auto", tol=1e-6,
                                factor_dtype=factor_dtype, print_level=0)
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
    ap.add_argument("--size", type=int, default=1000)
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
    fd = args.factor_dtype

    m, b, res = _solve(args.model, args.size, "cuda", fd)
    e0_card, f32_card = list(b.solver.e0), list(b.solver.f32)
    phases = b.solver.profile_phases()
    print(json.dumps({"phases_ms": {k: 1e3 * v for k, v in phases.items()}}))

    t0 = time.perf_counter()
    res = b.optimize(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps({"solve": {"status": res.status, "iterations": res.iter,
                                "objective": res.objective, "wall_s": wall,
                                "ms_per_iteration": 1e3 * wall / res.iter}}))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        b.optimize(m)
        torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if device_us(e) > 0]
    dev_us = sum(device_us(e) for e in events)
    launches = sum(e.count for e in events)
    k1_us = sum(device_us(e) for e in events if "chol_linv" in e.key)
    top = sorted(events, key=device_us, reverse=True)[:args.top]
    print(json.dumps({"profiler": {
        "wall_s": wall_prof, "device_busy_s": dev_us / 1e6,
        "device_busy_share": dev_us / 1e6 / wall_prof,
        "device_ops_with_time": launches,
        "k1_device_s": k1_us / 1e6,
        "top": [{"name": e.key[:80], "count": e.count,
                 "device_ms": device_us(e) / 1e3} for e in top]}}))

    def against_card(solver, res):
        e0 = solver.e0
        rel = [abs(a - c) / max(abs(c), 1e-300) for a, c in zip(e0_card, e0)]
        return {"iterations": res.iter, "status": res.status,
                "objective": res.objective,
                "f32_until": solver.f32[-1] if solver.f32 else None,
                "first_iteration_e0_rel_gt_1e-9": next(
                    (i for i, r in enumerate(rel) if r > 1e-9), None),
                "e0_rel_diff": rel, "e0": list(e0)}

    _, bc, rc = _solve(args.model, args.size, "cpu", fd)
    cpu = against_card(bc.solver, rc)
    k1 = block_tridiag._chol_linv
    block_tridiag._chol_linv = lambda D: chol_linv_reference(D.contiguous())
    try:
        _, bp, rp = _solve(args.model, args.size, "cuda", fd)
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
