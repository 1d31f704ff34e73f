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
   blocks of 64, K1 launched, ``first_order`` at the CPU record's
   objective.  The warm re-solve records the blocks of its last band
   factorization (11 K1 calls, a late iteration) through a hook around
   ``block_tridiag._chol_linv``;
5. determinism: quad-200 solved twice gives bit-identical iterates;
6. K1 on the recorded quad-1000 blocks: backward errors within 10x of the
   plain version's, and the kernel, plain and library times per
   factorization for the kernels line.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  The script exits non-zero and prints no
result when CUDA is absent.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

QUAD1000_OBJECTIVE = 568.839978   # reference CPU path, tol 1e-6 (BENCH_r05.json)
QUAD1000_LEVELS = (344, 172, 86, 43, 21, 11, 5, 3, 1, 1, 1)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.models import quad
    from infiniteexamodels_jl_torch.solvers import IpmSolver, block_tridiag
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
    chol_linv.launches = 0
    t0 = time.time()
    res = backend.optimize(m)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = chol_linv.launches
    kkt = backend.solver.kkt
    assert type(kkt) is BlockTridiagKKT, type(kkt)
    assert kkt.mode == "band" and kkt.nb == 688 and kkt.bs == 64, (
        kkt.mode, kkt.nb, kkt.bs)
    assert launches > 0, launches
    assert res.status == "first_order", res.status
    rel = abs(res.objective - QUAD1000_OBJECTIVE) / QUAD1000_OBJECTIVE
    assert rel <= 1e-6, (res.objective, rel)
    first_iters = res.iter
    # the re-solve also records the blocks of every K1 call: the last 11
    # are the last band factorization of the solve (a late iteration)
    seen = []
    k1 = block_tridiag._chol_linv

    def recording(D):
        seen.append(D.detach().clone(memory_format=torch.contiguous_format))
        del seen[:-len(QUAD1000_LEVELS)]
        return k1(D)

    block_tridiag._chol_linv = recording
    try:
        t0 = time.time()
        res2 = backend.optimize(m)      # re-solve with the built solver
        torch.cuda.synchronize()
        warm_s = time.time() - t0
    finally:
        block_tridiag._chol_linv = k1
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
        "k1_launches": launches,
        "k1_launches_per_factorization": len(QUAD1000_LEVELS)}))

    # 5. determinism: two quad-200 solves, every iterate bit-identical
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
        mq = quad(num_supports=200)
        b = ExaTranscriptionBackend(Recording, device="cuda",
                                    linear_solver="auto", tol=1e-6,
                                    print_level=0)
        mq.set_transformation_backend(b)
        r = b.optimize(mq)
        assert r.status == "first_order", r.status
        traces.append(Recording.trace)
    assert len(traces[0]) == len(traces[1]) > 0
    same = all(torch.equal(a, c) for a, c in zip(*traces))
    assert same, "quad-200 iterates differ between two runs"
    print(json.dumps({"determinism": "quad-200", "iterates": len(traces[0]),
                      "bit_identical": same}))

    # 6. K1 on the recorded quad-1000 blocks; the kernels line
    record = k1_main_path_record(seen, chol_linv, chol_linv_reference,
                                 launches)
    print(json.dumps({"elapsed_s": time.time() - t_start}))
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
