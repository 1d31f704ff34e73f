"""The reference's ESCAPE34 sweep harness (``run_cases``), through the port:
the counterpart of the repository's ``benchmarks/run_cases.py``, with its
command line, its solves and its CSV and LaTeX tables.

    python -m infiniteexamodels_jl_torch.tools.run_cases quad --sizes 4000 16000
    python -m infiniteexamodels_jl_torch.tools.run_cases pandemic --sizes "(25,4)" "(50,4)"
    python -m infiniteexamodels_jl_torch.tools.run_cases opf --sizes 2000 --device cpu

Runs on the CUDA card unless ``--device cpu`` is given (without CUDA and
without ``--device`` it raises; it never falls back to the CPU).  Each
configuration is solved twice through ``ExaTranscriptionBackend(IpmSolver,
linear_solver="auto", tol=1e-6)``, default ``max_iter``: a cold solve that
includes the build (``total_time``), then a warm re-solve of the built
solver after ``refresh_from_core`` (``solve_time``, ``iters``,
``objective``, ``status``).  The first configuration is solved once
before the sweep (the reference's JIT prerun; here it loads the card's
libraries and builds K1).

The CSV (``<outdir>/<name>_ipm_results.csv``) has that harness's
columns in its order: the model's keyword arguments, ``framework``,
``nvar``, ``ncon``, ``objective``, ``status``, ``total_time``,
``solve_time``, ``ad_time``, ``iters``.  ``ad_time`` is what its name
says: the seconds of the warm re-solve in NLP evaluations, the total of
its AD sweeps' spans (``ad.*``: objective, constraints, their
derivatives and the Hessian sweep, wherever the solver called them).  A
LaTeX table of the same rows is written beside it.

After each row one JSON line follows: the KKT's type, mode, ``nb``,
``bs`` and border; K1's launches per factorization over the cold solve,
counted on the card (``None`` on the CPU, where K1 does not launch) beside
what the structure gives (``BlockTridiagKKT.k1_launches_per_factorization``);
and the peak device memory over both solves above what was allocated
before the configuration was built (after a ``gc.collect()``; ``None`` on
the CPU).
"""
from __future__ import annotations

import argparse
import ast
import csv
import gc
import json
import os
import sys
import time

import torch

from .. import models as M
from ..backend import ExaTranscriptionBackend
from ..solvers import IpmSolver
from ..solvers.block_tridiag import BlockTridiagKKT
from ..solvers.chol_linv import chol_linv
from ..utils.device import resolve_device

FRAMEWORK = "InfiniteExaModelsTorch"
COLUMNS = ["framework", "nvar", "ncon", "objective", "status", "total_time",
           "solve_time", "ad_time", "iters"]
RESULTS = os.path.join(os.path.dirname(__file__), "results")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kkt_record(kkt, launches):
    """The KKT's type and shape, and K1's launches per factorization
    (counted on the card, and as the structure gives them)."""
    if not isinstance(kkt, BlockTridiagKKT):
        return {"kkt": type(kkt).__name__}
    counted = (launches / kkt.factorizations
               if launches and kkt.factorizations else None)
    return {"kkt": type(kkt).__name__, "mode": kkt.mode, "nb": kkt.nb,
            "bs": kkt.bs, "mB": kkt.mB,
            "k1_launches_per_factorization": counted,
            "k1_launches_per_factorization_structure":
            kkt.k1_launches_per_factorization()}


def ad_seconds(res):
    """Seconds of a solve in its AD sweeps (the spans ``ad.*``)."""
    return sum(t["self_s"] for path, t in res.spans.items()
               if path.rsplit("/", 1)[-1].startswith("ad."))


def solve_one(im_func, kwargs, device, linear_solver="auto"):
    """A cold solve (build included), then a warm re-solve; returns the
    CSV fields and the row's JSON record."""
    device = resolve_device(device)
    gc.collect()
    _sync(device)
    on_card = device.type == "cuda"
    if on_card:
        baseline = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    m = im_func(**kwargs)
    backend = ExaTranscriptionBackend(
        IpmSolver, device=device, linear_solver=linear_solver,
        print_level=0, tol=1e-6)
    m.set_transformation_backend(backend)
    chol_linv.launches = 0
    backend.optimize(m)
    _sync(device)
    total_time = time.time() - t0
    launches = chol_linv.launches
    kkt = backend.solver.kkt
    info = kkt_record(kkt, launches)
    # warm re-solve: the built solver from the model's start again
    backend.model.refresh_from_core()
    res = backend.solver.solve()
    _sync(device)
    info["peak_memory_above_baseline_bytes"] = (
        torch.cuda.max_memory_allocated(device) - baseline if on_card
        else None)
    out = dict(
        nvar=backend.model.nvar,
        ncon=backend.model.ncon,
        objective=res.objective,
        status=res.status,
        total_time=round(total_time, 3),
        solve_time=round(res.solve_time, 3),
        ad_time=round(ad_seconds(res), 3),
        iters=res.iter,
    )
    return out, info


def write_tables(name, rows, cols, outdir):
    """``<name>_ipm_results.csv`` and ``.tex`` in ``outdir``."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{name}_ipm_results.csv")
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=cols)
        w.writeheader()
        w.writerows(rows)
    print("wrote", path)
    tex = os.path.join(outdir, f"{name}_ipm_results.tex")
    with open(tex, "w") as fh:
        fh.write("\\begin{tabular}{" + "r" * len(cols) + "}\n\\toprule\n")
        fh.write(" & ".join(c.replace("_", "\\_") for c in cols)
                 + " \\\\\n\\midrule\n")
        for r in rows:
            fh.write(" & ".join(str(r[c]) for c in cols) + " \\\\\n")
        fh.write("\\bottomrule\n\\end{tabular}\n")
    print("wrote", tex)
    return path


def run_cases(name, im_func, kwarg_list, outdir, device, prerun=True):
    """Every configuration of ``kwarg_list``; returns the CSV's path."""
    if prerun:
        solve_one(im_func, kwarg_list[0], device)
    kw_keys = sorted(kwarg_list[0])
    rows = []
    for kwargs in kwarg_list:
        out, info = solve_one(im_func, kwargs, device)
        row = {k: kwargs[k] for k in kw_keys}
        row["framework"] = FRAMEWORK
        row.update(out)
        rows.append(row)
        print(row)
        print(json.dumps({"case": name, **kwargs, **info}), flush=True)
    return write_tables(name, rows, kw_keys + COLUMNS, outdir)


def cases(model, sizes):
    """(table name, model function, keyword arguments per size)."""
    if model == "pandemic":
        pairs = [ast.literal_eval(s) for s in sizes]
        return "pandemic", M.pandemic, [
            dict(num_supports=nt, num_scenarios=nx) for nt, nx in pairs]
    name, fn = {"quad": ("quadrotor", M.quad), "opf": ("opf", M.opf),
                "hovercraft": ("hovercraft", M.hovercraft),
                "kinetics": ("kinetics", M.kinetic_control)}[model]
    return name, fn, [dict(num_supports=int(s)) for s in sizes]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", choices=["quad", "pandemic", "opf",
                                      "hovercraft", "kinetics"])
    ap.add_argument("--sizes", nargs="+", required=True)
    ap.add_argument("--outdir", default=RESULTS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name, fn, kwargs = cases(args.model, args.sizes)
    run_cases(name, fn, kwargs, args.outdir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
