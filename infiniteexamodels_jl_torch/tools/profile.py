"""Where the time goes in one quadrotor solve on the CUDA card.

    python -m infiniteexamodels_jl_torch.tools.profile [--size 1000]

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
  K1 run's by more than 1e-9 relative.

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
from ..models import quad
from ..solvers import IpmSolver, block_tridiag
from ..solvers.chol_linv import chol_linv_reference


class _TracedIpm(IpmSolver):
    """IpmSolver that records the scaled KKT error E0 of every step."""

    def solve(self, *args, **kwargs):
        self.e0 = []
        return super().solve(*args, **kwargs)

    def _step(self, st, consts, kkt=None):
        st = super()._step(st, consts, kkt)
        self.e0.append(float(st.log_E0))
        return st


def _solve(size, device):
    m = quad(num_supports=size)
    b = ExaTranscriptionBackend(_TracedIpm, device=device,
                                linear_solver="auto", tol=1e-6,
                                print_level=0)
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
    ap.add_argument("--size", type=int, default=1000)
    ap.add_argument("--top", type=int, default=12)
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
    print(json.dumps({"card": card, "size": args.size}))

    m, b, res = _solve(args.size, "cuda")
    e0_card = list(b.solver.e0)
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

    def against_card(e0, res):
        rel = [abs(a - c) / max(abs(c), 1e-300) for a, c in zip(e0_card, e0)]
        return {"iterations": res.iter, "status": res.status,
                "objective": res.objective,
                "first_iteration_e0_rel_gt_1e-9": next(
                    (i for i, r in enumerate(rel) if r > 1e-9), None),
                "e0_rel_diff": rel, "e0": list(e0)}

    _, bc, rc = _solve(args.size, "cpu")
    cpu = against_card(bc.solver.e0, rc)
    k1 = block_tridiag._chol_linv
    block_tridiag._chol_linv = lambda D: chol_linv_reference(D.contiguous())
    try:
        _, bp, rp = _solve(args.size, "cuda")
    finally:
        block_tridiag._chol_linv = k1
    plain = against_card(bp.solver.e0, rp)
    print(json.dumps({"trajectory": {
        "card_k1": {"iterations": res.iter, "e0": e0_card},
        "host_cpu": cpu, "card_plain_chol_linv": plain}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
