"""Run every model family end to end at the sizes of the reference's
examples harness (``examples/runexamples.jl`` upstream), through the port.

    python -m infiniteexamodels_jl_torch.tools.run_examples [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.  Each family is
solved with ``linear_solver="auto"``, tol 1e-6, max_iter 600, silent, and
prints one line in the reference harness's format (status, iterations,
objective, primal feasibility, seconds), followed by the KKT the solver
chose (``band`` or ``block_diag``, blocks x width, border) and K1's
launches per factorization: the count K1's wrapper made on the card over
the factorizations of the solve, or ``-`` where the KKT is dense or the
device is the CPU (K1 launches only on the card), beside what the
structure gives.
"""
from __future__ import annotations

import argparse
import sys
import time

from .. import models as M
from ..backend import ExaTranscriptionBackend
from ..solvers import IpmSolver
from ..solvers.block_tridiag import BlockTridiagKKT
from ..solvers.chol_linv import chol_linv

CASES = [
    ("hovercraft", lambda: M.hovercraft(num_supports=101)),
    ("quadrotor", lambda: M.quad(num_supports=50)),
    ("kinetics", lambda: M.kinetic_control(num_supports=50)),
    ("pandemic", lambda: M.pandemic(num_supports=51, num_scenarios=4)),
    ("farmer", lambda: M.farmer(num_scenarios=1000)),
    ("3node_design", lambda: M.design_3node(num_scenarios=1000)),
    ("opf", lambda: M.opf(num_supports=100)),
]
OPTIONS = dict(linear_solver="auto", print_level=0, tol=1e-6, max_iter=600)


def kkt_summary(kkt, launches):
    """The KKT's mode and shape, and K1's launches per factorization
    (counted on the card, and as the structure gives them)."""
    if not isinstance(kkt, BlockTridiagKKT):
        return f"kkt={type(kkt).__name__}"
    per = kkt.k1_launches_per_factorization()
    counted = (f"{launches / kkt.factorizations:.1f}"
               if launches and kkt.factorizations else "-")
    return (f"kkt={kkt.mode} {kkt.nb}x{kkt.bs} border={kkt.mB} "
            f"k1/factorization={counted} (structure {per})")


def run(name, build, device):
    """Solve one family; returns (model, result, seconds, K1 launches)."""
    t0 = time.time()
    m = build()
    m.set_transformation_backend(ExaTranscriptionBackend(
        IpmSolver, device=device, **OPTIONS))
    chol_linv.launches = 0
    res = m.optimize()
    return m, res, time.time() - t0, chol_linv.launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    for name, build in CASES:
        m, res, secs, launches = run(name, build, args.device)
        print(f"{name:14s} {res.status:12s} iters={res.iter:4d} "
              f"obj={m.objective_value(): .6e} "
              f"pf={res.primal_feas:.1e} [{secs:.1f}s] "
              f"{kkt_summary(m.backend.solver.kkt, launches)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
