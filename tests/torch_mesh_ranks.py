"""Ranks of a CPU mesh for the port's multi-device tests.

:func:`launch` starts ``size`` processes of this file, each one rank of a
gloo process group on the CPU (``file://`` rendezvous in the test's
directory, so parallel test workers never share a port), waits for all of
them under a wall-clock limit (killing them when it passes), and returns
what each rank wrote.  A rank runs one *suite* -- every case a test file
needs -- and pickles its results to ``<dir>/<suite>-<rank>.pkl``; the test
file then asserts per case.  The ranks import torch and the port only.

    python tests/torch_mesh_ranks.py SUITE RANK SIZE DIR
"""
from __future__ import annotations

import datetime
import hashlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 60          # every collective of a rank gives up after this


def start(suite, size, tmp):
    """Start ``size`` ranks of ``suite``; :func:`wait` collects them."""
    tmp = Path(tmp)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(r), str(size), str(tmp)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(size)]
    return suite, tmp, procs


def wait(started, timeout=240):
    """The ranks' results in rank order.  Raises with their output when
    one fails, and kills them all when the wall-clock ``timeout`` passes."""
    suite, tmp, procs = started
    deadline = time.time() + timeout
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.time(), 1))
            logs.append(out)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{suite}: ranks passed {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"{suite} rank {r} exited {p.returncode}:\n"
                               f"{log[-4000:]}")
    results = []
    for r in range(len(procs)):
        with open(tmp / f"{suite}-{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def launch(suite, size, tmp, timeout=240):
    """Run ``suite`` on ``size`` ranks and return their results."""
    return wait(start(suite, size, tmp), timeout)


# ----------------------------------------------------------------------
# inputs shared with the tests (numpy seeds)
# ----------------------------------------------------------------------
def kkt_inputs(n, m, seed, shift=0.0, lam_scale=0.0):
    """(x shift, lam, d, diag_extra, rhs) of a KKT comparison, numpy."""
    rng = np.random.default_rng(seed)
    lam = (rng.standard_normal(m) * lam_scale if lam_scale
           else np.zeros(m))
    d = np.abs(rng.standard_normal(m)) * 0.1
    de = np.abs(rng.standard_normal(n)) + 5.0
    rhs = rng.standard_normal(n)
    return shift, lam, d, de, rhs


KKT_CASES = {
    # name: (model builder args, seed, x shift, lam scale)
    "scenario": (("pandemic", dict(num_supports=10, num_scenarios=16)), 3,
                 0.0, 0.0),
    "band": (("quad", dict(num_supports=24)), 7, 0.01, 0.1),
}
ROUNDTRIP_SEED = 11


def build(name, **kw):
    from infiniteexamodels_jl_torch import models
    return getattr(models, name)(**kw)


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# ----------------------------------------------------------------------
# suites (run on every rank)
# ----------------------------------------------------------------------
def _kkt_case(mesh, case):
    import torch
    from infiniteexamodels_jl_torch.parallel import shard_model
    from infiniteexamodels_jl_torch.solvers.band_shard import ShardedBandKKT
    from infiniteexamodels_jl_torch.solvers.scenario_shard import (
        ShardedScenarioKKT)
    from infiniteexamodels_jl_torch.transcribe import transcribe

    (name, kw), seed, shift, lam_scale = KKT_CASES[case]
    model, _ = transcribe(build(name, **kw), device="cpu", row_pad=mesh.size)
    shard_model(model, mesh)
    cls = ShardedScenarioKKT if case == "scenario" else ShardedBandKKT
    kkt = cls(model)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    shift, lam, d, de, rhs = kkt_inputs(model.nvar, model.ncon, seed, shift,
                                        lam_scale)
    x, th = model.x0 + shift, model.theta
    lam, d, de, rhs = t(lam), t(d), t(de), t(rhs)
    K = kkt.assemble(x, th, lam, 1.0, d, de)
    fac, ok = kkt.factor(K)
    out = dict(aligned=kkt.aligned, tlayout=kkt.tlayout, nb=kkt.nb,
               bs=kkt.bs, mB=kkt.mB, n=kkt.n, nd=kkt.nd, nb_loc=kkt.nb_loc,
               ok=bool(ok), matvec=kkt.matvec(K, rhs).numpy(),
               solve=kkt.solve(fac, rhs).numpy(),
               whole_system_tables=[
                   name for name in kkt.WHOLE_SYSTEM_TABLES
                   if getattr(kkt, name) is not None],
               block_elements=[int(a.numel()) for a in K[:2]])
    # one T-layout step: assemble, factor, a solve and a refinement round
    with mesh.recording() as log:
        K = kkt.assemble(x, th, lam, 1.0, d, de)
        fac, _ = kkt.factor(K)
        r = kkt.tl_gather(rhs)
        dx = kkt.solve_tl(fac, r)
        resid = kkt.tl_sub(r, kkt.matvec_tl(K, dx))
        dx = kkt.tl_add(dx, kkt.solve_tl(fac, resid))
        kkt.tl_norm(resid)
    out["step_log"] = list(log)
    with mesh.recording() as log:
        kkt.solve(fac, rhs)
    out["wrapper_log"] = list(log)
    # T-layout round trip and norm
    v = t(np.random.default_rng(ROUNDTRIP_SEED).standard_normal(model.nvar))
    out["roundtrip"] = kkt.tl_scatter(kkt.tl_gather(v)).numpy()
    out["tl_norm"] = float(kkt.tl_norm(kkt.tl_gather(v)))
    return out


def _evals(mesh):
    """farmer-80 and hovercraft-101 evaluations of the sharded model."""
    import torch
    from infiniteexamodels_jl_torch.parallel import (shard_model,
                                                     sharded_fraction)
    from infiniteexamodels_jl_torch.transcribe import transcribe

    out = {}
    for key, (name, kw), row_pad in (
            ("farmer80", ("farmer", dict(num_scenarios=80)), 1),
            ("hovercraft101", ("hovercraft", dict(num_supports=101)),
             mesh.size)):
        model, _ = transcribe(build(name, **kw), device="cpu",
                              row_pad=row_pad)
        shard_model(model, mesh)
        x, th = model.x0 + 0.05, model.theta
        lam = torch.linspace(0.1, 1.0, model.ncon, dtype=torch.float64)
        d = torch.full((model.ncon,), 2.0, dtype=torch.float64)
        v = torch.arange(model.nvar, dtype=torch.float64) / model.nvar
        with mesh.recording() as log:
            res = dict(
                obj=float(model.obj(x, th)), grad=model.grad(x, th).numpy(),
                cons=model.cons(x, th).numpy(),
                jac=model.jac_vals(x, th).numpy(),
                kkt=model.kkt_vals(x, th, lam, 1.5, d).numpy(),
                hvp=model.hvp_lag(x, th, lam, 1.5, v).numpy())
        res["log"] = list(log)
        res["fraction"] = sharded_fraction(model, mesh)
        res["local_rows"] = sum(model._nloc(f)
                                for f in model.con_fams + model.obj_fams)
        out[key] = res
    return out


def suite_parallel(mesh, tmp):
    from infiniteexamodels_jl_torch.parallel import make_mesh
    try:                    # the card is the default: no silent CPU mesh
        make_mesh()
        default = "made"
    except RuntimeError as e:
        default = str(e)
    return {"scenario": _kkt_case(mesh, "scenario"),
            "band": _kkt_case(mesh, "band"), "evals": _evals(mesh),
            "default_device": default}


def _mesh_solve(mesh, name, kw, **opts):
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.solvers import IpmSolver

    m = build(name, **kw)
    backend = ExaTranscriptionBackend(IpmSolver, mesh=mesh,
                                      linear_solver="auto", print_level=0,
                                      **opts)
    m.set_transformation_backend(backend)
    res = m.optimize()
    kkt = backend.solver.kkt
    return dict(kkt=type(kkt).__name__, aligned=getattr(kkt, "aligned",
                                                        None),
                status=res.status, iter=res.iter, objective=res.objective,
                x=res.solution, digest=digest(res.solution))


SOLVES = {
    "farmer16": ("farmer", dict(num_scenarios=16), {}),
    "farmer64": ("farmer", dict(num_scenarios=64), {}),
    "farmer64_mixed": ("farmer", dict(num_scenarios=64),
                       dict(factor_dtype="mixed")),
    "quad24": ("quad", dict(num_supports=24), dict(tol=1e-8)),
}
CHECKPOINT = ("quad", dict(num_supports=24), 4)   # model, cut iteration


def suite_solve(mesh, tmp):
    from infiniteexamodels_jl_torch.solvers import IpmSolver
    from infiniteexamodels_jl_torch.parallel import shard_model
    from infiniteexamodels_jl_torch.transcribe import transcribe

    out = {k: _mesh_solve(mesh, name, kw, **opts)
           for k, (name, kw, opts) in SOLVES.items()}
    # checkpoints across the layouts: resume the single-device one the
    # test wrote, and write one (rank 0) cut at the same iteration
    name, kw, cut = CHECKPOINT
    model, _ = transcribe(build(name, **kw), device="cpu",
                          row_pad=mesh.size)
    shard_model(model, mesh)
    solver = IpmSolver(model, linear_solver="auto", print_level=0)
    r = solver.solve(resume_from=str(Path(tmp) / "single.npz"))
    out["resumed"] = dict(status=r.status, iter=r.iter, x=r.solution,
                          kkt=type(solver.kkt).__name__)
    solver.solve(checkpoint_path=str(Path(tmp) / "sharded.npz"),
                 checkpoint_every=cut, max_iter=cut)
    return out


def suite_distributed(mesh, tmp):
    from infiniteexamodels_jl_torch.parallel.distributed import process_info
    out = _mesh_solve(mesh, "farmer", dict(num_scenarios=16))
    out["process_info"] = process_info()
    return out


SUITES = {"parallel": suite_parallel, "solve": suite_solve,
          "distributed": suite_distributed}


def main(suite, rank, size, tmp):
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    init = f"file://{Path(tmp) / (suite + '.rendezvous')}"
    if suite == "distributed":
        # the entry points a user calls
        from infiniteexamodels_jl_torch.parallel.distributed import (
            global_mesh, initialize)
        initialize(backend="gloo", init_method=init, world_size=size,
                   rank=rank, timeout=TIMEOUT_S)
        mesh = global_mesh(device="cpu")
    else:
        from infiniteexamodels_jl_torch.parallel import make_mesh
        dist.init_process_group(
            "gloo", init_method=init, world_size=size, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        mesh = make_mesh(device="cpu")
    try:
        out = SUITES[suite](mesh, tmp)
        with open(Path(tmp) / f"{suite}-{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
