"""Smoke test of the PyTorch port on one CUDA card (an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build every kernel of the port from ``infiniteexamodels_jl_torch/csrc``
   (one nvcc per source, all started together);
3. K1 (``chol_linv``): the kernel against its plain PyTorch version at the
   quad-1000 band shapes and beside them, both dtypes, the device-memory
   path (n > 120 in f64) and a block that is not SPD; per shape the
   kernel's, the plain version's and the library yardstick's times and the
   bound;
4. the main path: quad-1000 through ``ExaTranscriptionBackend(IpmSolver,
   linear_solver="auto", tol=1e-6)`` on the card -- band KKT with 688
   blocks of 64, K1 launched, ``first_order`` at the CPU record's
   objective;
5. determinism: quad-200 solved twice gives bit-identical iterates.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  The script exits non-zero and prints no
result when CUDA is absent.
"""
from __future__ import annotations

import json
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


def k1_phase(chol_linv, chol_linv_reference):
    cases = [(nb, 64, torch.float64) for nb in (344, 172, 43, 1)]
    cases += [(344, 64, torch.float32), (16, 8, torch.float64),
              (16, 24, torch.float64), (8, 120, torch.float64),
              (8, 128, torch.float64), (8, 128, torch.float32),
              (2, 512, torch.float64), (2, 512, torch.float32)]
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
        reps = 20 if n <= 128 else 3
        kernel_ms = cuda_ms(lambda: chol_linv(D), reps)
        plain_ms = cuda_ms(lambda: chol_linv_reference(D), reps)
        library_ms = cuda_ms(lambda: library(D), reps)
        bound_ms, bound_by = k1_bound_ms(nb, n, dt)
        print(json.dumps({"k1_shape": [nb, n, n], "dtype": str(dt),
                          "max_abs_err": err, "rel_err": err / scale,
                          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}))
    # a block that is not SPD: ok=False and NaN in that block, in both
    D = spd_batch(6, 64, torch.float64, seed=7)
    D[3] = -torch.eye(64, dtype=torch.float64, device="cuda")
    L, Linv, ok = chol_linv(D)
    Lr, Linvr, okr = chol_linv_reference(D)
    torch.cuda.synchronize()
    assert not bool(ok) and not bool(okr)
    assert bool(torch.isnan(L[3]).all()) and bool(torch.isnan(Linv[3]).all())
    keep = [0, 1, 2, 4, 5]
    assert float((L[keep] - Lr[keep]).abs().max()) <= 1e-10 * float(
        Lr[keep].abs().max())
    print(json.dumps({"k1_not_spd": "ok=False, NaN block, others agree"}))
    return worst


def k1_main_path_record(chol_linv, chol_linv_reference, launches):
    """The kernel line of the final JSON: times summed over the 11
    launches of one quad-1000 band factorization."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    err = 0.0
    for i, nb in enumerate(QUAD1000_LEVELS):
        D = spd_batch(nb, 64, torch.float64, seed=300 + i)
        L, Linv, _ = chol_linv(D)
        Lr, Linvr, _ = chol_linv_reference(D)
        err = max(err, float((L - Lr).abs().max()),
                  float((Linv - Linvr).abs().max()))
        tot["ms"] += cuda_ms(lambda: chol_linv(D), 20)
        tot["plain_ms"] += cuda_ms(lambda: chol_linv_reference(D), 20)
        tot["library_ms"] += cuda_ms(lambda: library(D), 20)
        tot["bound_ms"] += k1_bound_ms(nb, 64, torch.float64)[0]
    return {"name": "chol_linv", "route": "cuda",
            "source": "infiniteexamodels_jl_torch/csrc/chol_linv.cu",
            "replaces": "infiniteexamodels_jl_tpu/solvers/pallas_chol.py:90",
            "launches": launches, "max_abs_err": err, **tot,
            "bound_by": "bytes"}


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
        chol_linv, chol_linv_reference)
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
    worst = k1_phase(chol_linv, chol_linv_reference)
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
    t0 = time.time()
    res2 = backend.optimize(m)          # re-solve with the built solver
    torch.cuda.synchronize()
    warm_s = time.time() - t0
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

    record = k1_main_path_record(chol_linv, chol_linv_reference, launches)
    print(json.dumps({"elapsed_s": time.time() - t_start}))
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
