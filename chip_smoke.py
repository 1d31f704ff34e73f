"""Smoke test of the PyTorch port on one CUDA card (an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build every kernel of the port from ``infiniteexamodels_jl_torch/csrc``
   (one nvcc per source, all started together);
3. K1 (``chol_linv``): the kernel against its plain PyTorch version at the
   quad-1000 band shapes and at n = 8 ... 512 across both paths of its
   launch plan (CTA, with 8 down to 1 warps a block, and cluster), both
   dtypes; per shape the plan, the kernel's, the plain version's and the
   library yardstick's times and the bound.  Blocks that are not SPD (-I,
   and a pivot failing inside a diagonal tile) on every path; backward
   errors at cond 1e8 within 10x of the plain version's; two launches
   bit-identical;
4. the main path: quad-1000 through ``ExaTranscriptionBackend(IpmSolver,
   linear_solver="auto", tol=1e-6)`` on the card -- band KKT with 688
   blocks of 64, K1 launched 11 times per band factorization (counted),
   ``first_order`` at the CPU record's objective.  The warm re-solve records the blocks of its last band
   factorization (11 K1 calls, a late iteration) through a hook around
   ``block_tridiag._chol_linv``;
5. determinism: quad-200 solved twice gives bit-identical iterates;
6. K1 on the recorded quad-1000 blocks: backward errors within 10x of the
   plain version's, and the kernel, plain and library times per
   factorization for the kernels line;
7. scenario mode at the reference sweep's smallest and largest sizes: the
   two-stage stochastic AC-OPF (pglib case3_lmbd) with 1,000 and 16,000
   scenarios through the same backend -- ``BlockTridiagKKT`` in
   ``block_diag`` mode with S + 1 blocks of 24 and a border of 6, K1
   launched once per factorization (launches and factorizations counted),
   ``first_order`` at the JAX CPU record's objective; build, first-solve
   and warm re-solve times, K1 launches, peak device memory above what was
   allocated before the case (after a ``gc.collect()``), and the
   segment-sum plans' tables and entries.
   The opf-16000 re-solve records the blocks of its last factorization;
8. K1 on the recorded (16001, 24, 24) blocks: backward errors within 10x
   of the plain version's, kernel, plain and library device times;
9. farmer-1000 (the reference's default size) in ``block_diag`` mode with
   the 3 first-stage variables as border, ``first_order`` at the JAX CPU
   record;
10. determinism: opf-1000 solved twice gives bit-identical iterates.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  The script exits non-zero and prints no
result when CUDA is absent.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time

import torch

QUAD1000_OBJECTIVE = 568.839978   # reference CPU path, tol 1e-6 (BENCH_r05.json)
QUAD1000_LEVELS = (344, 172, 86, 43, 21, 11, 5, 3, 1, 1, 1)
# the JAX package on the host CPU, linear_solver="auto", tol=1e-6:
# scenarios -> (objective, iterations)
OPF_RECORDS = {1000: (5744.482317439771, 23), 16000: (5744.4823205514795, 18)}
FARMER1000 = (-90957.71953975875, 38)
HBM_BYTES_PER_S = 3.35e12         # H100 SXM
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12}
RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls (CUDA events, after
    one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_times(D, chol_linv, chol_linv_reference, reps):
    """Kernel, plain version and library call on the same blocks.  Device
    ms: ``reps`` calls in one CUDA graph (the kernel launched through its
    C entry point, without the wrapper).  Event ms: the calls issued one by
    one (the kernel through its wrapper), host included -- on short calls
    that measures the host's cost of issuing them."""
    from infiniteexamodels_jl_torch.tools.k1_sweep import graph_ms, launcher
    raw, _, _ = launcher(D)
    fns = {"kernel": (raw, lambda: chol_linv(D)),
           "plain": (lambda: chol_linv_reference(D),) * 2,
           "library": (lambda: library(D),) * 2}
    out = {}
    for name, (dev_fn, event_fn) in fns.items():
        out[name + "_device_ms"] = graph_ms(dev_fn, reps)
        out[name + "_event_ms"] = cuda_ms(event_fn, reps)
    return out


def spd_batch(nb, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(nb, n, n, generator=g, device="cuda", dtype=dtype)
    eye = torch.eye(n, device="cuda", dtype=dtype)
    return (A @ A.transpose(1, 2) / n + eye).contiguous()


def k1_bound_ms(nb, n, dtype):
    """Least time for one call: D read once, L and L^{-1} written once;
    n^3/3 flops for the Cholesky and n^3/3 for the triangular inverse."""
    esize = torch.finfo(dtype).bits // 8
    t_bytes = 3 * nb * n * n * esize / HBM_BYTES_PER_S
    t_ops = nb * (2.0 * n ** 3 / 3.0) / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library(D):
    """The yardstick: one cholesky_ex plus one triangular solve (timed
    only; the port never calls it for a CUDA tensor)."""
    L, _ = torch.linalg.cholesky_ex(D)
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(D), upper=False)


K1_SIZES = (8, 16, 24, 32, 40, 64, 120, 128, 144, 168, 176, 512)


def ill_conditioned_batch(nb, n, cond, seed):
    """SPD blocks with eigenvalues spread log-uniformly over [1/cond, 1]."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(nb, n, n, generator=g, device="cuda",
                    dtype=torch.float64)
    Q, _ = torch.linalg.qr(A)
    lam = torch.logspace(0.0, -math.log10(cond), n, device="cuda",
                         dtype=torch.float64)
    D = (Q * lam) @ Q.transpose(1, 2)
    return (0.5 * (D + D.transpose(1, 2))).contiguous()


def backward_errors(D, L, Linv):
    """||L L^T - D|| / ||D|| and ||L^{-1} L - I|| (Frobenius, worst
    block)."""
    eye = torch.eye(D.shape[-1], dtype=D.dtype, device=D.device)
    fact = torch.linalg.matrix_norm(L @ L.transpose(1, 2) - D)
    fact = float((fact / torch.linalg.matrix_norm(D)).max())
    return fact, float(torch.linalg.matrix_norm(Linv @ L - eye).max())


def check_backward(tag, D, chol_linv, chol_linv_reference):
    """The kernel's backward errors within 10x of the plain version's."""
    L, Linv, ok = chol_linv(D)
    Lr, Linvr, okr = chol_linv_reference(D)
    torch.cuda.synchronize()
    assert bool(ok) and bool(okr), tag
    fact, inv = backward_errors(D, L, Linv)
    fact_r, inv_r = backward_errors(D, Lr, Linvr)
    rec = {"k1_backward": tag, "shape": list(D.shape), "fact": fact,
           "fact_plain": fact_r, "inv": inv, "inv_plain": inv_r}
    print(json.dumps(rec))
    assert fact <= 10 * fact_r and inv <= 10 * inv_r, rec
    err = max(float((L - Lr).abs().max()), float((Linv - Linvr).abs().max()))
    scale = max(float(Lr.abs().max()), float(Linvr.abs().max()))
    return err, err / scale


def k1_phase(chol_linv, chol_linv_reference, launch_plan):
    cases = [(nb, 64, torch.float64) for nb in (344, 172, 43, 1)]
    cases += [(344, 64, torch.float32)]
    for n in K1_SIZES:
        nb = 16 if n <= 32 else (8 if n <= 176 else 2)
        cases += [(nb, n, torch.float64), (nb, n, torch.float32)]
    # many small blocks: CTAs of one warp (n = 8) and of four (n = 32, f64)
    cases += [(2048, n, dt) for n in (8, 32)
              for dt in (torch.float64, torch.float32)]
    worst = 0.0
    for i, (nb, n, dt) in enumerate(cases):
        D = spd_batch(nb, n, dt, seed=100 + i)
        L, Linv, ok = chol_linv(D)
        Lr, Linvr, okr = chol_linv_reference(D)
        torch.cuda.synchronize()
        assert bool(ok) and bool(okr), (nb, n, dt)
        err = max(float((L - Lr).abs().max()),
                  float((Linv - Linvr).abs().max()))
        scale = max(float(Lr.abs().max()), float(Linvr.abs().max()))
        assert err <= RTOL[dt] * scale, (nb, n, dt, err, scale)
        worst = max(worst, err / scale)
        reps = 20 if n <= 176 else 3
        times = k1_times(D, chol_linv, chol_linv_reference, reps)
        bound_ms, bound_by = k1_bound_ms(nb, n, dt)
        plan = launch_plan(n, dt, nb)
        print(json.dumps({"k1_shape": [nb, n, n], "dtype": str(dt),
                          "path": plan.path, "threads": plan.threads,
                          "max_abs_err": err, "rel_err": err / scale,
                          **times, "bound_ms": bound_ms,
                          "bound_by": bound_by}))
    # blocks that are not SPD, on every path: block 1 is -I, block 2 has
    # its pivot n/2 + 3 at -1 (inside a diagonal tile; past the first panel
    # from n = 16 on); both come back NaN, ok is False, the other blocks
    # agree with the plain version
    not_spd = ((4, 8), (4, 16), (2048, 16), (4, 64), (4, 144), (4, 512))
    for nb, n in not_spd:
        for dt in (torch.float64, torch.float32):
            D = spd_batch(nb, n, dt, seed=7 + n)
            D[1] = -torch.eye(n, dtype=dt, device="cuda")
            p = n // 2 + 3
            Lf = torch.linalg.cholesky(D[2])
            D[2, p, p] -= Lf[p, p] ** 2 + 1.0
            L, Linv, ok = chol_linv(D)
            Lr, Linvr, okr = chol_linv_reference(D)
            torch.cuda.synchronize()
            assert not bool(ok) and not bool(okr), (n, dt)
            for b in (1, 2):
                assert bool(torch.isnan(L[b]).all()), (n, dt, b)
                assert bool(torch.isnan(Linv[b]).all()), (n, dt, b)
            keep = [0] + list(range(3, nb))
            err = float((Linv[keep] - Linvr[keep]).abs().max())
            assert err <= RTOL[dt] * float(Linvr[keep].abs().max()), (
                n, dt, err)
    print(json.dumps({"k1_not_spd": "ok=False, NaN blocks (-I and a pivot "
                      "inside a diagonal tile), others agree",
                      "batches": not_spd}))
    # backward error at cond 1e8 (the condensed KKT's scale), every path
    for n in (24, 64, 128, 512):
        check_backward(f"cond1e8_n{n}", ill_conditioned_batch(
            4, n, 1e8, seed=500 + n), chol_linv, chol_linv_reference)
    # two launches give bit-identical outputs
    for n in (16, 64, 144, 512):
        D = spd_batch(4, n, torch.float64, seed=600 + n)
        a, b = chol_linv(D), chol_linv(D)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), n
    print(json.dumps({"k1_bit_identical": [16, 64, 144, 512]}))
    return worst


def k1_main_path_record(blocks, chol_linv, chol_linv_reference, launches):
    """The kernel line of the final JSON: times summed over the 11
    launches of one quad-1000 band factorization, on the real blocks that
    a late iteration of the solve factored."""
    tot = {}
    err = rel = bound_total = 0.0
    for i, D in enumerate(blocks):
        e, r = check_backward(f"quad1000_level{i}", D, chol_linv,
                              chol_linv_reference)
        err, rel = max(err, e), max(rel, r)
        for k, v in k1_times(D, chol_linv, chol_linv_reference, 20).items():
            tot[k] = tot.get(k, 0.0) + v
        bound_ms, bound_by = k1_bound_ms(D.shape[0], D.shape[-1], D.dtype)
        bound_total += bound_ms
        assert bound_by == "bytes", (D.shape, bound_by)
    # ms, plain_ms and library_ms are device times (CUDA graphs); the
    # CUDA-event times of the calls issued one by one, host included, are
    # kept beside them
    names = ("kernel", "plain", "library")
    return {"name": "chol_linv", "route": "cuda",
            "source": "infiniteexamodels_jl_torch/csrc/chol_linv.cu",
            "replaces": "infiniteexamodels_jl_tpu/solvers/pallas_chol.py:90",
            "launches": launches, "max_abs_err": err, "max_rel_err": rel,
            "ms": tot["kernel_device_ms"], "plain_ms": tot["plain_device_ms"],
            "bound_ms": bound_total, "bound_by": "bytes",
            "library_ms": tot["library_device_ms"],
            "event_ms": {k: tot[k + "_event_ms"] for k in names}}


def solve_recorded(backend, m, chol_linv, seen=None, keep=1):
    """One solve on the card, with K1's launches (its count set to 0 just
    before) and the band/scenario KKT's factorizations (a hook around
    ``BlockTridiagKKT.factor``) counted; with ``seen``, the blocks of the
    last ``keep`` K1 calls are kept through a hook around
    ``block_tridiag._chol_linv``.  Returns (result, seconds, launches,
    factorizations)."""
    from infiniteexamodels_jl_torch.solvers import block_tridiag
    k1 = block_tridiag._chol_linv
    factor = block_tridiag.BlockTridiagKKT.factor
    factorizations = [0]

    def recording(D):
        seen.append(D.detach().clone(memory_format=torch.contiguous_format))
        del seen[:-keep]
        return k1(D)

    def counted(self, K):
        factorizations[0] += 1
        return factor(self, K)

    if seen is not None:
        block_tridiag._chol_linv = recording
    block_tridiag.BlockTridiagKKT.factor = counted
    try:
        chol_linv.launches = 0
        t0 = time.time()
        res = backend.optimize(m)
        torch.cuda.synchronize()
        return res, time.time() - t0, chol_linv.launches, factorizations[0]
    finally:
        block_tridiag._chol_linv = k1
        block_tridiag.BlockTridiagKKT.factor = factor


def segsum_plans(model, kkt):
    """Every segment-sum plan of the model and its KKT, by name."""
    return {"grad": model._grad_plan, "hvp": model._hvp_plan,
            "jprod": model._jprod_plan, "jtprod": model._jtprod_plan,
            "D": kkt.D_plan, "L": kkt.L_plan, "B": kkt.B_plan,
            "C": kkt.C_plan}


def segsum_record(model, kkt):
    """The plans' take-tables (one gather and one row reduction each per
    call) and their total entries."""
    plans = segsum_plans(model, kkt)
    return {"segsum_tables": {k: len(p.tabs) for k, p in plans.items()},
            "segsum_table_entries": sum(p.entries for p in plans.values())}


def scenario_solve(tag, m, record, bs, mB, chol_linv, seen=None):
    """``m`` through the scenario KKT on the card: first solve with K1's
    count read around it, then a warm re-solve (recording blocks when
    ``seen`` is given).  Asserts the structure, K1's launches, the status
    and the objective against the JAX CPU record; prints one line."""
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.solvers import IpmSolver
    from infiniteexamodels_jl_torch.solvers.block_tridiag import (
        BlockTridiagKKT)
    objective, cpu_iters = record
    # what earlier phases left allocated (collected first) is the baseline
    # the peak is read against
    gc.collect()
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    backend = ExaTranscriptionBackend(IpmSolver, device="cuda",
                                      linear_solver="auto", tol=1e-6,
                                      print_level=0)
    m.set_transformation_backend(backend)
    backend.build(m)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    # the first solve builds the solver and its KKT (structure analysis)
    res, first_s, launches, factorizations = solve_recorded(backend, m,
                                                            chol_linv)
    kkt = backend.solver.kkt
    # a dense fallback would factor an (n, n) matrix: never on this path
    assert type(kkt) is BlockTridiagKKT, type(kkt)
    nb = kkt.nb
    assert (kkt.mode, kkt.bs, kkt.mB) == ("block_diag", bs, mB), (
        kkt.mode, kkt.bs, kkt.mB)
    assert launches > 0, launches
    # block_diag factors every block in one K1 launch
    per_factorization = launches / factorizations
    assert per_factorization == 1, (launches, factorizations)
    assert res.status == "first_order", (tag, res.status)
    rel = abs(res.objective - objective) / abs(objective)
    assert rel <= 1e-6, (tag, res.objective, rel)
    res2, warm_s, _, _ = solve_recorded(backend, m, chol_linv, seen)
    peak = torch.cuda.max_memory_allocated()
    assert res2.status == "first_order" and res2.iter == res.iter, (
        res2.status, res2.iter)
    print(json.dumps({
        "scenario": tag, "nvar": backend.model.nvar,
        "ncon": backend.model.ncon, "kkt": type(kkt).__name__,
        "mode": kkt.mode, "nb": nb, "bs": kkt.bs, "mB": kkt.mB,
        "status": res.status, "iterations": res.iter,
        "reference_cpu_iterations": cpu_iters, "objective": res.objective,
        "objective_rel_err": rel, "build_s": build_s,
        "first_solve_s": first_s, "warm_resolve_s": warm_s,
        "k1_launches": launches, "factorizations": factorizations,
        "k1_launches_per_factorization": per_factorization,
        "memory_baseline_bytes": baseline,
        "peak_memory_above_baseline_bytes": peak - baseline,
        **segsum_record(backend.model, kkt)}))
    return nb, launches, per_factorization


def k1_scenario_record(D, launches, per_factorization, chol_linv,
                       chol_linv_reference):
    """K1 at the scenario shape on real blocks: backward errors, device
    times (kernel, plain, library) and the bound of one factorization;
    ``launches`` and ``per_factorization`` are the solve's, as counted."""
    err, rel = check_backward("opf16000_blocks", D, chol_linv,
                              chol_linv_reference)
    times = k1_times(D, chol_linv, chol_linv_reference, 20)
    bound_ms, bound_by = k1_bound_ms(D.shape[0], D.shape[-1], D.dtype)
    return {"shape": list(D.shape), "dtype": str(D.dtype),
            "launches_per_factorization": per_factorization,
            "launches": launches,
            "max_abs_err": err, "max_rel_err": rel,
            "ms": times["kernel_device_ms"],
            "plain_ms": times["plain_device_ms"],
            "library_ms": times["library_device_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "event_ms": {k: times[k + "_event_ms"]
                         for k in ("kernel", "plain", "library")}}


def determinism(tag, make_model):
    """Two solves of ``make_model()`` on the card: every iterate
    bit-identical."""
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.solvers import IpmSolver

    class Recording(IpmSolver):
        trace = []

        def _step(self, st, consts, kkt=None):
            st = super()._step(st, consts, kkt)
            Recording.trace.append(
                torch.cat([st.x, st.s, st.y, st.zl, st.zu]).clone())
            return st

    traces = []
    for _ in range(2):
        Recording.trace = []
        m = make_model()
        b = ExaTranscriptionBackend(Recording, device="cuda",
                                    linear_solver="auto", tol=1e-6,
                                    print_level=0)
        m.set_transformation_backend(b)
        r = b.optimize(m)
        assert r.status == "first_order", r.status
        traces.append(Recording.trace)
    assert len(traces[0]) == len(traces[1]) > 0
    same = all(torch.equal(a, c) for a, c in zip(*traces))
    assert same, f"{tag} iterates differ between two runs"
    print(json.dumps({"determinism": tag, "iterates": len(traces[0]),
                      "bit_identical": same}))


def scenario_phases(chol_linv, chol_linv_reference):
    """Phases 7-10; returns K1's record at the opf-16000 shape."""
    from infiniteexamodels_jl_torch.models import farmer, opf

    # 7. scenario mode: opf-1000 and opf-16000 (the reference sweep's
    # smallest and largest sizes)
    for S in (1000, 16000):
        blocks = [] if S == 16000 else None
        nb, launches, per_fact = scenario_solve(
            f"opf-{S}", opf(num_supports=S), OPF_RECORDS[S], 24, 6,
            chol_linv, blocks)
        assert nb == S + 1, (S, nb)
    # 8. K1 on the recorded opf-16000 blocks (the last factorization of
    # the warm re-solve)
    (D,) = blocks
    assert tuple(D.shape) == (16001, 24, 24), D.shape
    record = k1_scenario_record(D, launches, per_fact, chol_linv,
                                chol_linv_reference)
    del blocks, D
    # 9. farmer-1000, the reference's default size
    nb, _, _ = scenario_solve("farmer-1000", farmer(num_scenarios=1000),
                           FARMER1000, 8, 3, chol_linv)
    assert nb == 1000, nb
    # 10. determinism: two opf-1000 solves
    determinism("opf-1000", lambda: opf(num_supports=1000))
    return record


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.models import quad
    from infiniteexamodels_jl_torch.solvers import IpmSolver
    from infiniteexamodels_jl_torch.solvers.block_tridiag import (
        BlockTridiagKKT)
    from infiniteexamodels_jl_torch.solvers.chol_linv import (
        chol_linv, chol_linv_reference, launch_plan)
    from infiniteexamodels_jl_torch.utils.cuda_build import build_all

    t_start = time.time()
    # 1. the card
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}))

    # 2. build every kernel of the port
    t0 = time.time()
    logs = build_all(["chol_linv"])
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}")
    print(json.dumps({"build_s": time.time() - t0}))

    # 3. K1 against its plain version
    worst = k1_phase(chol_linv, chol_linv_reference, launch_plan)
    print(json.dumps({"k1_worst_rel_err": worst}))

    # 4. the main path: quad-1000 on the card
    t0 = time.time()
    m = quad(num_supports=1000)
    backend = ExaTranscriptionBackend(IpmSolver, device="cuda",
                                      linear_solver="auto", tol=1e-6,
                                      print_level=5)
    m.set_transformation_backend(backend)
    backend.build(m)
    build_s = time.time() - t0
    res, first_s, launches, factorizations = solve_recorded(backend, m,
                                                            chol_linv)
    kkt = backend.solver.kkt
    assert type(kkt) is BlockTridiagKKT, type(kkt)
    assert kkt.mode == "band" and kkt.nb == 688 and kkt.bs == 64, (
        kkt.mode, kkt.nb, kkt.bs)
    assert launches > 0, launches
    # one K1 launch per BCR level
    per_factorization = launches / factorizations
    assert per_factorization == len(QUAD1000_LEVELS), (launches,
                                                       factorizations)
    assert res.status == "first_order", res.status
    rel = abs(res.objective - QUAD1000_OBJECTIVE) / QUAD1000_OBJECTIVE
    assert rel <= 1e-6, (res.objective, rel)
    first_iters = res.iter
    # the re-solve (with the built solver) also records the blocks of every
    # K1 call: the last 11 are the last band factorization of the solve (a
    # late iteration)
    seen = []
    res2, warm_s, _, _ = solve_recorded(backend, m, chol_linv, seen,
                                        keep=len(QUAD1000_LEVELS))
    assert tuple(D.shape[0] for D in seen) == QUAD1000_LEVELS, [
        D.shape for D in seen]
    assert res2.status == "first_order" and res2.iter == first_iters
    print(json.dumps({
        "main_path": "quad-1000", "nvar": backend.model.nvar,
        "ncon": backend.model.ncon, "kkt": type(kkt).__name__,
        "mode": kkt.mode, "nb": kkt.nb, "bs": kkt.bs,
        "status": res.status, "iterations": first_iters,
        "reference_cpu_iterations": 10, "objective": res.objective,
        "objective_rel_err": rel, "build_s": build_s,
        "first_solve_s": first_s, "warm_resolve_s": warm_s,
        "iters_per_s_warm": first_iters / warm_s,
        "k1_launches": launches, "factorizations": factorizations,
        "k1_launches_per_factorization": per_factorization,
        **segsum_record(backend.model, kkt)}))

    # 5. determinism: two quad-200 solves, every iterate bit-identical
    determinism("quad-200", lambda: quad(num_supports=200))

    # 6. K1 on the recorded quad-1000 blocks; the kernels line
    record = k1_main_path_record(seen, chol_linv, chol_linv_reference,
                                 launches)
    del m, backend, kkt, seen

    # 7.-10. scenario mode
    record["opf16000"] = scenario_phases(chol_linv, chol_linv_reference)

    print(json.dumps({"elapsed_s": time.time() - t_start}))
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
