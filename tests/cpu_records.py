"""The JAX package's records on the host CPU that chip_smoke phases 17
and 18 and PERF.md hold the port against (and, with ``--package port``,
the port's on the same CPU).

    python -m tests.cpu_records --set examples   # examples/run_examples.py
    python -m tests.cpu_records --set kinetics   # kinetics-50, three routes
    python -m tests.cpu_records --set pandemic   # the slow tests' options
    python -m tests.cpu_records --set sweep      # pandemic (25,4)..(100,8)
    python -m tests.cpu_records --set escape34   # the ESCAPE34 sweep points

Each case is one JSON line: status, iterations, objective (full
precision), primal and dual feasibility, nvar, ncon, wall seconds and the
KKT's mode and shape.  ``examples`` solves examples/run_examples.py's seven
cases with its options (``linear_solver="auto"``, tol 1e-6, max_iter 600);
``kinetics`` solves kinetics-50 with those options through the JAX
package's three exact KKT routes (``"auto"``, ``"dense"``, ``"ldl_cpp"``);
``pandemic`` the three slow pandemic tests of tests/test_models.py with
their options ((100,32) takes hours); ``sweep`` the reference's pandemic
sweep points with run_examples' options; ``escape34`` the reference's
ESCAPE34 sweep points that chip_smoke phase 18 and
``infiniteexamodels_jl_torch.tools.run_cases`` hold the port to (quad
2,000-16,000 supports, opf 2,000-8,000 scenarios, pandemic (25,4), (50,4),
(100,4) and (100,8)) with the options of benchmarks/run_cases.py's
``solve_one`` (``linear_solver="auto"``, tol 1e-6, the default
``max_iter``).  No tier-1 test runs a set; ``--case`` runs one case.

``--x0-noise EPS --seed K`` multiplies every start value by
``1 + EPS * N(0, 1)`` (numpy, seed K) before the solve: how far the JAX
package's own result moves under a perturbation of the size of round-off
(``--case`` picks one case of the set by name).

A solve continued from another's state:

    python -m tests.cpu_records --set pandemic --case pandemic-100x8 \
        --checkpoint-at 352 --checkpoint st352.npz   # the JAX state at 352
    python -m tests.cpu_records --set pandemic --case pandemic-100x8 \
        --resume-from st352.npz [--package port] [--state-noise 1e-12 --seed K]

``--checkpoint-at K`` stops the solve at the host return of iteration K
and writes its state to ``--checkpoint`` (the packages share the format);
``--resume-from`` continues a solve from such a state, with
``--state-noise EPS`` multiplying its x by ``1 + EPS * N(0, 1)`` first.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

import infiniteexamodels_jl_tpu as jpkg  # noqa: E402
import infiniteexamodels_jl_torch as tpkg  # noqa: E402
from infiniteexamodels_jl_tpu import models as jmodels  # noqa: E402
from infiniteexamodels_jl_torch import models as tmodels  # noqa: E402
from infiniteexamodels_jl_tpu.solvers.block_tridiag import (  # noqa: E402
    BlockTridiagKKT as JBlockKKT)
from infiniteexamodels_jl_torch.solvers.block_tridiag import (  # noqa: E402
    BlockTridiagKKT as TBlockKKT)

EXAMPLES = dict(linear_solver="auto", print_level=0, tol=1e-6, max_iter=600)
RUN_CASES = dict(linear_solver="auto", print_level=0, tol=1e-6)
ESCAPE34 = ([("quad", n) for n in (2000, 4000, 8000, 16000)]
            + [("opf", s) for s in (2000, 4000, 8000)]
            + [("pandemic", p) for p in ((25, 4), (50, 4), (100, 4),
                                         (100, 8))])


def escape34_name(model, size):
    """quad-2000, opf-2000, pandemic-25x4."""
    if model == "pandemic":
        return f"pandemic-{size[0]}x{size[1]}"
    return f"{model}-{size}"


def _cases(which, M):
    if which == "examples":
        return [(name, build, EXAMPLES) for name, build in (
            ("hovercraft", lambda: M.hovercraft(num_supports=101)),
            ("quadrotor", lambda: M.quad(num_supports=50)),
            ("kinetics", lambda: M.kinetic_control(num_supports=50)),
            ("pandemic", lambda: M.pandemic(num_supports=51,
                                            num_scenarios=4)),
            ("farmer", lambda: M.farmer(num_scenarios=1000)),
            ("3node_design", lambda: M.design_3node(num_scenarios=1000)),
            ("opf", lambda: M.opf(num_supports=100)))]
    if which == "kinetics":
        return [(f"kinetics-50 {ls}",
                 lambda: M.kinetic_control(num_supports=50),
                 dict(EXAMPLES, linear_solver=ls))
                for ls in ("auto", "dense", "ldl_cpp")]
    if which == "escape34":
        build = {"quad": lambda n: M.quad(num_supports=n),
                 "opf": lambda n: M.opf(num_supports=n),
                 "pandemic": lambda p: M.pandemic(num_supports=p[0],
                                                  num_scenarios=p[1])}
        return [(escape34_name(name, size),
                 lambda f=build[name], a=size: f(a), RUN_CASES)
                for name, size in ESCAPE34]
    if which == "sweep":
        return [(f"pandemic-{nt}x{nxi}",
                 lambda nt=nt, nxi=nxi: M.pandemic(num_supports=nt,
                                                   num_scenarios=nxi),
                 EXAMPLES)
                for nt, nxi in ((25, 4), (50, 4), (100, 4), (100, 8))]
    base = dict(linear_solver="auto", print_level=0, tol=1e-6)
    return [
        ("pandemic-51x4", lambda: M.pandemic(num_supports=51,
                                             num_scenarios=4),
         dict(base, max_iter=800)),
        ("pandemic-100x8", lambda: M.pandemic(num_supports=100,
                                              num_scenarios=8),
         dict(base, max_iter=600)),
        ("pandemic-100x32", lambda: M.pandemic(num_supports=100,
                                               num_scenarios=32,
                                               elastic_rho=500.0),
         dict(base, max_iter=900, dual_init="lsq", recalc_y_stall=True)),
    ]


def _continued(solver, resume_from=None, save=None):
    """``solver`` resuming from ``resume_from`` or writing its state at
    ``save = (path, iteration)``."""
    class Continued(solver):
        def solve(self, *a, **k):
            if resume_from is not None:
                k["resume_from"] = resume_from
            if save is not None:
                k.update(checkpoint_path=save[0], checkpoint_every=save[1])
            return super().solve(*a, **k)
    return Continued


def _noisy_state(path, eps, seed):
    """A copy of the checkpoint at ``path`` with x times 1 + eps N(0, 1)."""
    st = dict(np.load(path))
    rng = np.random.default_rng(seed)
    st["x"] = st["x"] * (1.0 + eps * rng.standard_normal(st["x"].shape))
    out = f"{path}.noise{eps:g}.seed{seed}.npz"
    np.savez(out, **st)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", default="examples",
                    choices=("examples", "kinetics", "pandemic", "sweep",
                             "escape34"))
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--case", default=None)
    ap.add_argument("--x0-noise", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-at", type=int, default=None)
    ap.add_argument("--checkpoint", default="checkpoint.npz")
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--state-noise", type=float, default=0.0)
    args = ap.parse_args(argv)
    save = resume = None
    if args.checkpoint_at is not None:
        save = (args.checkpoint, args.checkpoint_at)
    if args.resume_from is not None:
        resume = (_noisy_state(args.resume_from, args.state_noise, args.seed)
                  if args.state_noise else args.resume_from)
    pkg, models, extra = ((jpkg, jmodels, {}) if args.package == "jax"
                          else (tpkg, tmodels, dict(device="cpu")))
    for name, build, opts in _cases(args.set, models):
        if args.case is not None and name != args.case:
            continue
        t0 = time.time()
        m = build()
        if save is not None:
            opts = dict(opts, max_iter=save[1])
        solver = pkg.IpmSolver
        if save is not None or resume is not None:
            solver = _continued(solver, resume, save)
            name = (f"{name} to {save[1]}" if save is not None else
                    f"{name} from {args.resume_from}"
                    + (f" state-noise {args.state_noise} seed {args.seed}"
                       if args.state_noise else ""))
        b = pkg.ExaTranscriptionBackend(solver, **extra, **opts)
        m.set_transformation_backend(b)
        if args.x0_noise:
            b.build(m)
            x0 = np.asarray(b.model.core.x0, dtype=float)
            rng = np.random.default_rng(args.seed)
            b.model.core.set_x0_flat(
                x0 * (1.0 + args.x0_noise * rng.standard_normal(x0.shape)))
            b.model.refresh_from_core()
            name = f"{name} x0-noise {args.x0_noise} seed {args.seed}"
        res = b.optimize(m) if args.x0_noise else m.optimize()
        kkt = m.backend.solver.kkt
        shape = (dict(mode=kkt.mode, nb=kkt.nb, bs=kkt.bs, mB=kkt.mB)
                 if isinstance(kkt, (JBlockKKT, TBlockKKT))
                 else type(kkt).__name__)
        print(json.dumps(dict(
            package=args.package, case=name, status=res.status,
            iter=int(res.iter),
            objective=float(m.objective_value()),
            primal_feas=float(res.primal_feas),
            dual_feas=float(res.dual_feas), nvar=int(b.model.nvar),
            ncon=int(b.model.ncon), s=time.time() - t0,
            kkt=shape)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
