"""Warm re-solve time of one model on the CUDA card.

    python -m infiniteexamodels_jl_torch.tools.resolve_time [--model quad]
        [--size 1000] [--reps 3]

``--model`` names a function of ``infiniteexamodels_jl_torch.models`` that
takes ``num_supports`` (``quad``, ``hovercraft``, ``opf``) and ``--size`` is
that count.  The model is built and solved once (which builds the solver,
its KKT and the kernels); then ``--reps`` warm re-solves are timed, each
between two ``torch.cuda.synchronize()``.  Prints the card's name and power
limit, then one JSON line: the package timed, the status, the iterations,
each re-solve's wall seconds and its milliseconds per iteration.

The imports are absolute, so a copy of this file times whichever checkout
of the package comes first on ``PYTHONPATH``: two versions compared in one
run on one card.  Exits non-zero when CUDA is absent.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="quad")
    ap.add_argument("--size", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("resolve_time: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import infiniteexamodels_jl_torch as pkg
    from infiniteexamodels_jl_torch import models
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.solvers import IpmSolver

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    m = getattr(models, args.model)(num_supports=args.size)
    backend = ExaTranscriptionBackend(IpmSolver, device="cuda",
                                      linear_solver="auto", tol=1e-6,
                                      print_level=0)
    m.set_transformation_backend(backend)
    backend.build(m)
    first = backend.optimize(m)
    secs = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = backend.optimize(m)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        assert (res.status, res.iter) == (first.status, first.iter), (
            res.status, res.iter)
    print(json.dumps({"resolve_time": f"{args.model}-{args.size}",
                      "package": pkg.__file__, "status": first.status,
                      "iterations": first.iter, "objective": first.objective,
                      "warm_resolve_s": secs,
                      "ms_per_iteration": [1e3 * s / first.iter
                                           for s in secs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
