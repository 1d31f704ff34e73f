"""Smoke test of the PyTorch port on one CUDA card (an H100).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build every kernel of the port from ``infiniteexamodels_jl_torch/csrc``
   (one nvcc per source, all started together) and the host LDL library
   (g++);
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
   ``block_tridiag._chol_linv``.  Every band solve of phases 4, 7, 9, 17
   and 18 also launches K2 (``bcr_level``) twice a BCR level in every
   factorization (counted; none in ``block_diag`` mode);
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
   and warm re-solve times, K1 launches, peak device memory over the build
   and the first solve above what was allocated before the case (after a
   ``gc.collect()``), and the segment-sum plans' tables and entries.
   The opf-16000 re-solve records the blocks of its last factorization;
8. K1 on the recorded (16001, 24, 24) blocks: backward errors within 10x
   of the plain version's, kernel, plain and library device times; the
   same blocks cast to f32: the three device times and the blocks K1 and
   the plain version reject;
9. farmer-1000 (the reference's default size) in ``block_diag`` mode with
   the 3 first-stage variables as border, ``first_order`` at the JAX CPU
   record;
10. determinism: opf-1000 solved twice gives bit-identical iterates;
11. the low-precision step sets: quad-1000 through the same backend with
    ``factor_dtype`` "mixed", "ir32" and "float32" -- ``first_order`` at
    the f64 record, K1's launches split by dtype (f32 launches asserted),
    where the f32 phase handed over to f64 and why, first and warm solve
    seconds, ms per step in the f32 and f64 phases, beside the JAX
    package's CPU record of the same step set;
12. K1 in f32 on the blocks of the last f32 band factorization of the
    "mixed" solve: backward errors within 10x of the plain version's, the
    kernel, plain and library device times and the bound, and the blocks
    that K1 and that its plain version reject over every f32
    factorization of the solve (the plain version factors each f32 call's
    blocks beside K1) (the ``f32`` record of the kernels line);
13. opf-1000 and opf-100 with ``factor_dtype="mixed"`` in ``block_diag``
    mode: one K1 launch per factorization, f32 ones counted,
    ``first_order`` at the JAX CPU record of "mixed" (first solve only);
    K1 in f32 on the (S + 1, 24, 24) blocks of its last f32 factorization,
    backward errors within 10x of the plain version's (over the blocks it
    factors); the blocks each rejects over the f32 factorizations;
14. the host LDL on the card's tensors: quad-200 with
    ``linear_solver="ldl_cpp"``, ``first_order`` within 1e-8 of the band
    path's objective on the card, ms per iteration of both;
15. checkpoint and trace at quad-200 (f64 band): a solve cut at iteration
    4 and resumed ends bit-identical to an uninterrupted one, in as many
    iterations; a solve with ``trace_dir`` (three iterations) exports a
    trace that names K1 among its CUDA kernels;
16. the multi-device backends: 4 ranks (processes) sharing the card over
    gloo (NCCL refuses two ranks on one GPU), each through
    ``ExaTranscriptionBackend(IpmSolver, mesh=global_mesh(),
    linear_solver="auto", tol=1e-6)`` at full width: farmer-1000 through
    ``ShardedScenarioKKT`` (1,000 blocks of 8, 250 a rank, border 3) and
    quad-1000 through ``ShardedBandKKT`` (688 band blocks of 64 padded to
    1,024, 256 a rank).  Both ``first_order`` at the records; K1 launched
    in every factorization on every rank (1 and 11 a factorization,
    counted per rank); the final x bit-identical on every rank (hashes
    all-gathered).  Per case: iterations beside the single-card phases'
    and the JAX CPU record, first and warm solve seconds, K1 launches and
    build seconds per rank, the collectives of one factorization (count
    and elements by kind), the ops gloo staged through host memory, peak
    device memory per rank above a baseline read after one warm call of
    every library routine the solve uses, over the first solve (without
    the recording of K1's inputs), and that memory by holder (the model's
    tables and plans, the KKT's, one iterate, the gathered value streams,
    one K with its factorization, the rest); K1 against its plain version
    on rank 0's blocks of its last factorization (the ``sharded`` record of
    the kernels line).  The ranks share one card and each drives its own
    host process, so their times say nothing of scaling;
17. the families no earlier phase runs, through the same backend at the
    sizes of the reference's examples harness and of its pandemic tests:
    hovercraft-101 (band 65 x 16), kinetics-50 (band 50 x 24),
    design_3node-1000 (``block_diag`` 1,000 x 8, border 3), pandemic
    (51,4) (band 36 x 56, max_iter 800), (100,8) (band 100 x 72, max_iter
    600) and (100,32) with the certificate's options (elastic cap, the
    least-squares dual start, the stall-triggered recalc, max_iter 900:
    band 1,320 x 24 with a border of 110).  Each: status, iterations,
    objective, primal and dual feasibility, first (and, for the short
    cases, warm) seconds, the KKT's mode and shape, K1 launched BCR levels
    + 1 times in every factorization (counted); held to the JAX package's
    CPU record (hovercraft, design_3node: objective within 1e-6 relative;
    kinetics: within 1e-6 of the nearest of the JAX package's three exact
    KKT routes) or to the bounds of its pandemic tests; K1 against its
    plain version on the blocks of the case's last factorization (the
    ``families`` record of the kernels line).  With a border, every border
    factor the card computes is held against the same S factored in f64 on
    the host, and the bordered solve's backward error ||K x - r|| / ||r||
    (through ``matvec``) of the last K is printed.  The two longest,
    pandemic (51,4) and (100,8), run in a process of their own, started
    before phase 13 and joined here (on their host-bound steps the card is
    busy a few percent of the time; the times printed by phases 13-17
    include that sharing), and every case's K1 record is taken after the
    join;
18. the reference's ESCAPE34 sweep points (its ``run_cases`` harness;
    ``infiniteexamodels_jl_torch.tools.run_cases`` runs the others):
    quad-4000 and quad-16000 through the same backend -- ``BlockTridiagKKT``
    band 2,750 x 64 and 11,000 x 64 with no border (asserted: a dense
    fallback would factor an (n, n) matrix), K1 launched ceil(log2 nb) + 1
    times in every factorization (13 and 15, counted), ``first_order``
    within 1e-6 of the JAX CPU record, iterations printed beside the JAX
    count; build, first-solve and warm re-solve seconds, iterations per
    second and peak device memory above a baseline; K1 on the blocks of
    quad-16000's last band factorization (backward errors within 10x of
    the plain version's; kernel, plain, library and bound, the
    ``escape34`` record of the kernels line); K2 on the inputs of that
    factorization's 14 BCR levels, recorded through a hook around
    ``bcr_level.bcr_level``: each level's backward error (its reduced
    system against the level's Schur complement on a random vector) within
    10x of the plain version's, and K2's, the plain version's and the byte
    bound's ms over the 14 levels, in f64 and on the same inputs cast to
    f32 (the ``bcr_level`` record of the kernels line); opf-2000 (capped at 150
    iterations), opf-4000 and opf-8000 as in phase 7; pandemic (100,128)
    cut at 50 iterations as (100,32) in phase 17 (band 7,040 x 16 with a
    border of 110, 14 K1 launches a factorization, every border factor
    held against the host's, the iterate finite).

From phase 4 on, every f64 K1 call of the solves on this card (phase
16's spawned ranks excepted) is also put through the plain version's
pivot test (LAPACK's, ``cholesky_ex``): the f64 census.  Per phase it
prints the f64 factorizations, K1's calls and blocks, the blocks each
version rejects, by both and alone, and the blocks K1 factors with a
least pivot in (sqrt(n) u, 2 n u] D_jj; each solve's line carries its own
(``blocks_rejected_f64``), and the kernels line every phase's.  The solve
goes on with K1's result and K1's launch count does not move; times and
peak memory include the census's ``cholesky_ex``.

The second-to-last line is the kernels' JSON record (K1's, then K2's); the
last line is
``{"ok": true, "device": {...}}``.  The script exits non-zero and prints no
result when CUDA is absent.
"""
from __future__ import annotations

import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import types

import torch

QUAD1000_OBJECTIVE = 568.839978   # reference CPU path, tol 1e-6 (BENCH_r05.json)
QUAD1000_LEVELS = (344, 172, 86, 43, 21, 11, 5, 3, 1, 1, 1)
# the JAX package on the host CPU, linear_solver="auto", tol=1e-6:
# scenarios -> (objective, iterations)
OPF_RECORDS = {1000: (5744.482317439771, 23), 16000: (5744.4823205514795, 18)}
FARMER1000 = (-90957.71953975875, 38)
# the JAX package on the host CPU, linear_solver="auto", tol=1e-6, in each
# low-precision step set: (status, iterations, objective, last f32 step,
# why the f32 phase ended); by `python -m tests.torch_vs_jax_trajectory
# --model quad --size 1000 --factor-dtype <set>` (and `--model opf`)
QUAD1000_LOWPREC = {
    "mixed": ("first_order", 25, 568.8399758259147, 4, "mu_switch"),
    "ir32": ("first_order", 31, 568.8399758433759, 25, "demotion"),
    "float32": ("first_order", 23, 568.8399758433637, 4, "demotion"),
}
# opf-S "mixed", the same tools and options: S -> (status, iterations,
# objective, last f32 step, why the f32 phase ended)
OPF_MIXED = {1000: ("first_order", 15, 5744.482320299224, 1, "demotion"),
             100: ("first_order", 62, 5744.482296956747, 44, "demotion")}
ROOT = pathlib.Path(__file__).resolve().parent
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


def k1_main_path_record(blocks, chol_linv, chol_linv_reference, launches,
                        tag="quad1000"):
    """The kernel line of the final JSON: times summed over the launches
    of one band factorization (quad-1000's 11 unless ``tag`` names another
    case), on the real blocks that a late iteration of the solve
    factored."""
    tot = {}
    err = rel = bound_total = 0.0
    for i, D in enumerate(blocks):
        e, r = check_backward(f"{tag}_level{i}", D, chol_linv,
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


def level_residual(L, Epad, D_even, D_next, E_next, y):
    """A BCR level's backward error: its reduced system (``D_next`` odd
    blocks first, ``E_next`` with its zero tail, as K2 writes them) applied
    to ``y`` against the level's Schur complement applied to ``y`` through
    triangular solves with ``L`` (in f64), relative to ``|D_even| |y|``:
    an SPD band's Gram updates are bounded by its even blocks."""
    f = torch.float64
    L, Epad, D_even, D_next = (t.to(f) for t in (L, Epad, D_even, D_next))
    m_odd, m_even = L.shape[0], D_even.shape[0]
    E_odd, E_even = Epad[1::2], Epad[0::2][:m_odd]
    ypad = torch.cat([y, y.new_zeros((1,) + y.shape[1:])])
    u = E_even @ y[:m_odd] + E_odd.transpose(1, 2) @ ypad[1:m_odd + 1]
    z = torch.linalg.solve_triangular(L, u, upper=False)
    z = torch.linalg.solve_triangular(L.transpose(1, 2), z, upper=True)
    Sy = D_even @ y
    Sy[:m_odd] -= E_even.transpose(1, 2) @ z
    Sy[1:] -= (E_odd @ z)[:m_even - 1]
    half = m_even // 2
    D_new = torch.empty_like(D_even)
    D_new[1::2], D_new[0::2] = D_next[:half], D_next[half:]
    Ty = D_new @ y
    if E_next is not None:
        E_new = E_next[:-1].to(f)
        Ty[1:] += E_new @ y[:-1]
        Ty[:-1] += E_new.transpose(1, 2) @ y[1:]
    scale = float((D_even.abs() @ y.abs()).max())
    return float((Ty - Sy).abs().max()) / scale


def k2_level_record(L, Epad, D_even, reps):
    """K2 and its plain version on one recorded level: each one's backward
    error (:func:`level_residual`), device ms (``reps`` calls in a CUDA
    graph) and the level's byte bound."""
    from infiniteexamodels_jl_torch.solvers.bcr_level import (
        bcr_level, bcr_level_reference, level_bytes)
    from infiniteexamodels_jl_torch.tools.k1_sweep import graph_ms
    m_odd, m_even, n = L.shape[0], D_even.shape[0], L.shape[-1]
    half = m_even // 2
    D_next = torch.empty_like(D_even)
    E_next = None if m_even == 1 else torch.empty_like(D_even)

    def kernel():
        bcr_level(L, Epad, D_even, D_next, E_next)

    def plain():
        return bcr_level_reference(L, Epad[1::2], Epad[0::2][:m_odd],
                                   D_even)

    kernel()
    D_ref, E_ref = plain()
    P_next = torch.empty_like(D_even)
    P_next[:half], P_next[half:] = D_ref[1::2], D_ref[0::2]
    P_E = None
    if E_next is not None:
        P_E = torch.cat([E_ref, E_ref.new_zeros((1, n, n))])
    g = torch.Generator(device="cuda").manual_seed(m_even)
    y = torch.randn((m_even, n, 1), generator=g, device="cuda",
                    dtype=torch.float64)
    esize = torch.finfo(L.dtype).bits // 8
    return {"m": Epad.shape[0], "dtype": str(L.dtype).replace("torch.", ""),
            "backward": level_residual(L, Epad, D_even, D_next, E_next, y),
            "backward_plain": level_residual(L, Epad, D_even, P_next, P_E,
                                             y),
            "ms": graph_ms(kernel, reps), "plain_ms": graph_ms(plain, reps),
            "bound_ms": 1e3 * level_bytes(Epad.shape[0], n, esize)
            / HBM_BYTES_PER_S}


def k2_main_path_record(calls, launches, reps=5):
    """K2's record of the kernels line: the inputs ``(L, Epad, D_even)`` of
    every BCR level of one band factorization of the solve, each level's
    backward error held within 10x of the plain version's (or of 8 n u),
    and K2's, the plain version's and the byte bound's ms summed over the
    levels; then the same on the inputs cast to f32."""
    rec = {"name": "bcr_level", "route": "cuda",
           "source": "infiniteexamodels_jl_torch/csrc/bcr_level.cu",
           "replaces": None, "launches": launches, "levels": len(calls),
           "shapes": [list(c[1].shape) for c in calls]}
    for dtype in (torch.float64, torch.float32):
        rows = []
        for L, Epad, D_even in calls:
            row = k2_level_record(*(t.to(dtype) for t in (L, Epad, D_even)),
                                  reps)
            n = L.shape[-1]
            floor = 8 * n * torch.finfo(dtype).eps
            assert row["backward"] <= max(10 * row["backward_plain"],
                                          floor), row
            print(json.dumps({"k2_level": row}))
            rows.append(row)
        tot = {k: sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms")}
        part = {**tot, "bound_by": "bytes",
                "max_backward": max(r["backward"] for r in rows),
                "max_backward_plain": max(r["backward_plain"]
                                          for r in rows)}
        if dtype is torch.float64:
            rec.update(part)
        else:
            rec["f32"] = part
    return rec


def rejections():
    """A tally of K1's calls on one dtype's blocks: the calls, their blocks,
    and the blocks K1 and its plain version reject (not SPD by their pivot
    tests), by both and by each alone.  In f64 also the KKT factorizations,
    the blocks K1 factors with a least pivot p in (sqrt(n) u, 2 n u] D_jj
    (``flip_band``: passed by a test at sqrt(n) u, failed by one at 2 n u,
    twice a pivot's worst-case rounding error), and over the blocks only
    the plain version rejects, the least and the greatest of K1's pivot
    p_j / (u D_jj) at the pivot where LAPACK stopped
    (``plain_only_k1_pivot_u``).  Counts are kept on the card until
    ``counts()`` reads them."""
    return {"calls": 0, "blocks": 0, "k1": 0, "plain": 0, "k1_only": 0,
            "plain_only": 0}


def counts(tally):
    """``tally`` read back: counts as ints, pivot ranges as [least,
    greatest] (None where no block was seen)."""
    out = {}
    for k, v in tally.items():
        if torch.is_tensor(v) and v.is_floating_point():
            lo, hi = (float(x) for x in v)
            out[k] = [lo, hi] if math.isfinite(lo) else None
        else:
            out[k] = int(v)
    return out


def rejected_blocks(D, L):
    """One K1 call's tally (``rejections()``'s keys): ``L`` is K1's factor
    of the contiguous ``D``; the plain version's test (LAPACK's,
    ``cholesky_ex``: a computed pivot <= 0) runs on the same blocks.  A
    comparison: the solve goes on with K1's result, K1's launch count does
    not move, and nothing waits for the card."""
    bad = ~torch.isfinite(L).flatten(1).all(1)
    info = torch.linalg.cholesky_ex(D).info
    bad_r = info != 0
    flags = [bad, bad_r, bad & ~bad_r, bad_r & ~bad]
    out = {"calls": 1, "blocks": D.shape[0]}
    if D.dtype == torch.float64:
        n, u = D.shape[-1], torch.finfo(D.dtype).eps / 2
        piv = (torch.diagonal(L, dim1=-2, dim2=-1) ** 2
               / torch.diagonal(D, dim1=-2, dim2=-1)) / u
        least = piv.amin(-1)
        flags.append((least > math.sqrt(n)) & (least <= 2 * n))
        # info: the order of the leading minor LAPACK found not SPD
        at = piv.gather(-1, (info.long() - 1).clamp(min=0)[:, None])[:, 0]
        only = flags[3]
        out["plain_only_k1_pivot_u"] = torch.stack([
            torch.where(only, at, math.inf).amin(),
            torch.where(only, at, -math.inf).amax()])
    keys = ("k1", "plain", "k1_only", "plain_only", "flip_band")
    out.update(zip(keys, torch.stack(flags).sum(1)))
    return out


def add_rejections(tally, rec):
    """Adds one call's ``rejected_blocks`` to ``tally``."""
    for k, v in rec.items():
        if k == "plain_only_k1_pivot_u":
            prev = tally.get(k)
            tally[k] = v if prev is None else torch.stack(
                [torch.minimum(prev[0], v[0]), torch.maximum(prev[1], v[1])])
        else:
            tally[k] = tally.get(k, 0) + v


class Census:
    """K1's f64 census: around ``block_tridiag._chol_linv`` and
    ``BlockTridiagKKT.factor`` for the whole run (phase 16's spawned ranks
    run the same kernel and are left out), every f64 call's blocks tallied
    (``rejected_blocks``) into the current phase's tally and, while a
    solve runs through ``solve_recorded``, into that solve's
    (``last``)."""

    def __init__(self):
        self.phase, self.phases, self.extra = None, {}, {}
        self.reports = {}
        self.solve = self.last = None

    def begin(self, phase):
        self.phase, self.t0 = phase, time.time()

    def install(self):
        from infiniteexamodels_jl_torch.solvers import block_tridiag
        self.k1 = block_tridiag._chol_linv
        factor = block_tridiag.BlockTridiagKKT.factor

        def counted(kkt, K):
            if (kkt.factor_dtype or K[0].dtype) == torch.float64:
                for t in self.tallies():
                    t["factorizations"] = t.get("factorizations", 0) + 1
            return factor(kkt, K)
        block_tridiag._chol_linv = self
        block_tridiag.BlockTridiagKKT.factor = counted

    def tallies(self):
        t = [self.phases.setdefault(self.phase, rejections())]
        return t + [self.solve] if self.solve is not None else t

    def __call__(self, D):
        out = self.k1(D)
        if D.dtype == torch.float64:
            rec = rejected_blocks(D.contiguous(), out[0])
            for t in self.tallies():
                add_rejections(t, rec)
        return out

    def report(self):
        """Prints the current phase's tally (with ``extra``'s, read back in
        another process) and seconds; keeps the tally, read back, in
        ``reports``."""
        rec = counts(self.phases.get(self.phase, rejections()))
        for k, v in self.extra.get(self.phase, {}).items():
            if k == "plain_only_k1_pivot_u":
                both = [r for r in (rec.get(k), v) if r is not None]
                rec[k] = [min(r[0] for r in both),
                          max(r[1] for r in both)] if both else None
            else:
                rec[k] = rec.get(k, 0) + v
        print(json.dumps({"census_f64": self.phase, **rec,
                          "phase_s": time.time() - self.t0}))
        self.reports[self.phase] = rec


CENSUS = Census()


def solve_recorded(backend, m, chol_linv, seen=None, keep=1, dtype=None,
                   last_K=None, tally=None, k2_seen=None, k2_keep=1):
    """One solve on the card, with K1's launches (its count set to 0 just
    before) and the band/scenario KKT's factorizations (a hook around
    ``BlockTridiagKKT.factor``) counted, and both counted again by dtype
    (K1's through a hook around ``block_tridiag._chol_linv``); with
    ``seen``, the blocks of the last ``keep`` calls (of ``dtype``, when
    given) are kept; with ``last_K`` (a list), the last assembled K that
    was factored; with ``tally`` (``rejections()``), the blocks K1 and its
    plain version reject in every f32 call (the f64 calls' in
    ``CENSUS.last``); with ``k2_seen``, the inputs ``(L, Epad, D_even)``
    of K2's last ``k2_keep`` calls.  Returns (result, seconds,
    launches, factorizations, {"k1": launches by dtype, "factor":
    factorizations by dtype, "k2": K2's launches, its count set to 0 just
    before})."""
    from infiniteexamodels_jl_torch.solvers import bcr_level, block_tridiag
    k1 = block_tridiag._chol_linv
    k2 = bcr_level.bcr_level
    factor = block_tridiag.BlockTridiagKKT.factor
    factorizations = [0]
    by_dtype = {"k1": {}, "factor": {}}

    def count(kind, dt):
        name = str(dt).replace("torch.", "")
        by_dtype[kind][name] = by_dtype[kind].get(name, 0) + 1

    def recording(D):
        count("k1", D.dtype)
        if seen is not None and (dtype is None or D.dtype == dtype):
            seen.append(D.detach().clone(
                memory_format=torch.contiguous_format))
            del seen[:-keep]
        out = k1(D)
        if tally is not None and D.dtype == torch.float32:
            add_rejections(tally, rejected_blocks(D.contiguous(), out[0]))
        return out

    def counted(self, K):
        factorizations[0] += 1
        count("factor", self.factor_dtype or K[0].dtype)
        if last_K is not None:
            last_K[:] = [K]
        return factor(self, K)

    def k2_recording(L, Epad, D_even, D_next, E_next):
        k2_seen.append(tuple(t.detach().clone(
            memory_format=torch.contiguous_format) for t in (L, Epad,
                                                             D_even)))
        del k2_seen[:-k2_keep]
        return k2(L, Epad, D_even, D_next, E_next)

    block_tridiag._chol_linv = recording
    block_tridiag.BlockTridiagKKT.factor = counted
    if k2_seen is not None:     # the factorization's name for the module
        block_tridiag.bcr_level = types.SimpleNamespace(
            bcr_level=k2_recording)
    CENSUS.solve = rejections()
    try:
        chol_linv.launches = 0
        k2.launches = 0
        t0 = time.time()
        res = backend.optimize(m)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    finally:
        block_tridiag._chol_linv = k1
        block_tridiag.BlockTridiagKKT.factor = factor
        block_tridiag.bcr_level = bcr_level
        CENSUS.last, CENSUS.solve = counts(CENSUS.solve), None
    by_dtype["k2"] = k2.launches
    # every call launched the kernel (the tensors are on the card)
    assert sum(by_dtype["k1"].values()) == chol_linv.launches, (
        by_dtype, chol_linv.launches)
    return res, seconds, chol_linv.launches, factorizations[0], by_dtype


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


def structured_solve(tag, m, record, shape, per, chol_linv, seen=None,
                     keep=1, max_iter=None, k2_seen=None):
    """``m`` through the band or scenario KKT on the card: a first solve
    (K1's launches counted around it; peak device memory read over the
    build and it, above what was allocated before, after a
    ``gc.collect()``), then a warm re-solve (recording the blocks of its
    last ``keep`` K1 calls into ``seen`` when given).  Asserts the KKT's
    type and ``shape`` = (mode, nb, bs, mB) (a dense fallback would factor
    an (n, n) matrix), ``per`` K1 launches in every factorization and K2's
    two a BCR level (``per - 1`` levels; none in ``block_diag`` mode), and
    the status and objective (within 1e-6 relative) of the JAX CPU
    ``record`` = (status, iterations, objective); prints one line and
    returns it.  ``max_iter`` caps both solves (the solver's default when
    None); ``k2_seen`` records the inputs of K2's calls in the warm
    re-solve's last factorization."""
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.solvers import IpmSolver
    from infiniteexamodels_jl_torch.solvers.block_tridiag import (
        BlockTridiagKKT)
    status, cpu_iters, objective = record
    gc.collect()
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    opts = {} if max_iter is None else {"max_iter": max_iter}
    backend = ExaTranscriptionBackend(IpmSolver, device="cuda",
                                      linear_solver="auto", tol=1e-6,
                                      print_level=0, **opts)
    m.set_transformation_backend(backend)
    backend.build(m)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    # the first solve builds the solver and its KKT (structure analysis)
    res, first_s, launches, facts, by = solve_recorded(backend, m, chol_linv)
    census = CENSUS.last
    peak = torch.cuda.max_memory_allocated() - baseline
    kkt = backend.solver.kkt
    assert type(kkt) is BlockTridiagKKT, (tag, type(kkt))
    assert (kkt.mode, kkt.nb, kkt.bs, kkt.mB) == shape, (
        tag, kkt.mode, kkt.nb, kkt.bs, kkt.mB)
    assert kkt.k1_launches_per_factorization() == per, tag
    assert facts > 0 and launches == per * facts, (tag, launches, facts)
    assert by["k2"] == 2 * (per - 1) * facts, (tag, by["k2"], facts)
    assert res.status == status, (tag, res.status)
    rel = abs(res.objective - objective) / abs(objective)
    assert rel <= 1e-6, (tag, res.objective, rel)
    res2, warm_s, _, _, _ = solve_recorded(backend, m, chol_linv, seen,
                                           keep=keep, k2_seen=k2_seen,
                                           k2_keep=per - 1)
    assert (res2.status, res2.iter) == (res.status, res.iter), (
        tag, res2.status, res2.iter)
    line = {"case": tag, "nvar": backend.model.nvar,
            "ncon": backend.model.ncon, "kkt": type(kkt).__name__,
            "mode": kkt.mode, "nb": kkt.nb, "bs": kkt.bs, "mB": kkt.mB,
            "status": res.status, "iterations": res.iter,
            "jax_cpu_iterations": cpu_iters, "objective": res.objective,
            "jax_cpu_objective": objective, "objective_rel_err": rel,
            "build_s": build_s, "first_solve_s": first_s,
            "warm_resolve_s": warm_s, "iters_per_s_warm": res.iter / warm_s,
            "k1_launches": launches, "factorizations": facts,
            "k1_launches_per_factorization": launches / facts,
            "k2_launches": by["k2"],
            "blocks_rejected_f64": census,
            "memory_baseline_bytes": baseline,
            "peak_memory_above_baseline_bytes": peak,
            **segsum_record(backend.model, kkt)}
    print(json.dumps(line))
    return line


def k1_scenario_record(D, launches, per_factorization, chol_linv,
                       chol_linv_reference):
    """K1 at the scenario shape on real blocks: backward errors, device
    times (kernel, plain, library) and the bound of one factorization;
    ``launches`` and ``per_factorization`` are the solve's, as counted."""
    err, rel = check_backward("opf16000_blocks", D, chol_linv,
                              chol_linv_reference)
    times = k1_times(D, chol_linv, chol_linv_reference, 20)
    bound_ms, bound_by = k1_bound_ms(D.shape[0], D.shape[-1], D.dtype)
    # the same blocks in f32 (the f32 step sets' scenario shape): device
    # times and the blocks each version rejects
    D32 = D.float().contiguous()
    times32 = k1_times(D32, chol_linv, chol_linv_reference, 20)
    bound32, _ = k1_bound_ms(D32.shape[0], D32.shape[-1], D32.dtype)
    rejected = rejected_blocks(D32, chol_linv(D32)[0])
    return {"shape": list(D.shape), "dtype": str(D.dtype),
            "launches_per_factorization": per_factorization,
            "launches": launches,
            "max_abs_err": err, "max_rel_err": rel,
            "ms": times["kernel_device_ms"],
            "plain_ms": times["plain_device_ms"],
            "library_ms": times["library_device_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "event_ms": {k: times[k + "_event_ms"]
                         for k in ("kernel", "plain", "library")},
            "f32": {"ms": times32["kernel_device_ms"],
                    "plain_ms": times32["plain_device_ms"],
                    "library_ms": times32["library_device_ms"],
                    "bound_ms": bound32,
                    "blocks_rejected": counts(rejected)}}


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
    # smallest and largest sizes); block_diag factors every block in one
    # K1 launch
    CENSUS.begin("7")
    for S in (1000, 16000):
        blocks = [] if S == 16000 else None
        objective, iters = OPF_RECORDS[S]
        line = structured_solve(
            f"opf-{S}", opf(num_supports=S),
            ("first_order", iters, objective), ("block_diag", S + 1, 24, 6),
            1, chol_linv, blocks)
    # 8. K1 on the recorded opf-16000 blocks (the last factorization of
    # the warm re-solve)
    (D,) = blocks
    assert tuple(D.shape) == (16001, 24, 24), D.shape
    record = k1_scenario_record(D, line["k1_launches"], 1, chol_linv,
                                chol_linv_reference)
    del blocks, D
    CENSUS.report()
    # 9. farmer-1000, the reference's default size
    CENSUS.begin("9")
    structured_solve("farmer-1000", farmer(num_scenarios=1000),
                     ("first_order", FARMER1000[1], FARMER1000[0]),
                     ("block_diag", 1000, 8, 3), 1, chol_linv)
    CENSUS.report()
    # 10. determinism: two opf-1000 solves
    CENSUS.begin("10")
    determinism("opf-1000", lambda: opf(num_supports=1000))
    CENSUS.report()
    return record


def timed_solver():
    """``IpmSolver`` that records (f32 step set?, status, iter, seconds) of
    every step; a step's time ends when its status is on the host."""
    from infiniteexamodels_jl_torch.solvers import IpmSolver

    class Timed(IpmSolver):
        def solve(self, *a, **k):
            self.steps = []
            return super().solve(*a, **k)

        def _step(self, st, consts, kkt=None):
            t0 = time.time()
            st = super()._step(st, consts, kkt)
            code = int(st.status)
            self.steps.append((kkt is not None and kkt is self.kkt32, code,
                               int(st.iter), time.time() - t0))
            return st
    return Timed


def f32_phase(steps):
    """Where the f32 step set handed over to f64 (the iteration of its last
    step and why), and ms per step in each phase."""
    from infiniteexamodels_jl_torch.solvers.ipm import DEMOTE_F32
    f32 = [st for st in steps if st[0]]
    f64 = [st for st in steps if not st[0]]
    last = f32[-1] if f32 else None
    handover = None
    if last is not None and f64:
        handover = [last[2], "demotion" if last[1] == DEMOTE_F32
                    else "mu_switch"]
    ms = {k: 1e3 * sum(st[3] for st in v) / len(v) if v else None
          for k, v in (("f32", f32), ("f64", f64))}
    return handover, len(f32), len(f64), ms


def lowprec_quad_phase(chol_linv):
    """Phase 11: quad-1000 in each low-precision step set; returns the
    blocks of the last f32 band factorization of the "mixed" solve and that
    solve's f32 K1 launches, f32 factorizations and the blocks K1 and its
    plain version rejected in them."""
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.models import quad
    from infiniteexamodels_jl_torch.solvers.block_tridiag import (
        BlockTridiagKKT)
    Timed = timed_solver()
    blocks, mixed = [], None
    for fd, record in QUAD1000_LOWPREC.items():
        m = quad(num_supports=1000)
        backend = ExaTranscriptionBackend(Timed, device="cuda",
                                          linear_solver="auto", tol=1e-6,
                                          factor_dtype=fd, print_level=0)
        m.set_transformation_backend(backend)
        backend.build(m)
        seen = blocks if fd == "mixed" else None
        tally = rejections()
        res, first_s, launches, facts, by_dtype = solve_recorded(
            backend, m, chol_linv, seen, keep=len(QUAD1000_LEVELS),
            dtype=torch.float32, tally=tally)
        census = CENSUS.last
        solver = backend.solver
        assert type(solver.kkt) is BlockTridiagKKT, type(solver.kkt)
        assert solver.kkt32 is not None and solver.kkt.mode == "band"
        assert res.status == "first_order", (fd, res.status)
        rel = abs(res.objective - QUAD1000_OBJECTIVE) / QUAD1000_OBJECTIVE
        assert rel <= 1e-6, (fd, res.objective, rel)
        # the f32 step set really factored in f32, on the card's kernel
        assert by_dtype["k1"].get("float32", 0) > 0, (fd, by_dtype)
        handover, n32, n64, _ = f32_phase(solver.steps)
        res2, warm_s, _, _, _ = solve_recorded(backend, m, chol_linv)
        assert res2.status == "first_order" and res2.iter == res.iter, (
            fd, res2.status, res2.iter, res.iter)
        _, _, _, ms = f32_phase(solver.steps)
        print(json.dumps({
            "lowprec": "quad-1000", "factor_dtype": fd,
            "status": res.status, "iterations": res.iter,
            "objective": res.objective, "objective_rel_err": rel,
            "f32_until": handover, "f32_steps": n32, "f64_steps": n64,
            "k1_launches": launches, "by_dtype": by_dtype,
            "factorizations": facts,
            "blocks_rejected_f32": counts(tally),
            "blocks_rejected_f64": census,
            "first_solve_s": first_s,
            "warm_resolve_s": warm_s, "warm_ms_per_step": ms,
            "jax_cpu_record": dict(zip(
                ("status", "iterations", "objective", "f32_until", "by"),
                record))}))
        if fd == "mixed":
            mixed = (by_dtype["k1"]["float32"],
                     by_dtype["factor"]["float32"], tally)
        del m, backend, solver
    assert tuple(D.shape[0] for D in blocks) == QUAD1000_LEVELS, [
        D.shape for D in blocks]
    assert all(D.dtype == torch.float32 for D in blocks)
    return blocks, mixed


def backward_f32(D, chol_linv, chol_linv_reference):
    """K1 and its plain version in f32 on real blocks that the solve
    factored with K1: the worst backward errors of both (the plain
    version's over the blocks it factors too), the largest difference
    there, and how many blocks the plain version failed."""
    L, Linv, okb = chol_linv(D)
    Lr, Linvr, _ = chol_linv_reference(D)
    torch.cuda.synchronize()
    assert bool(okb), D.shape        # the solve went on with this factor
    good = torch.isfinite(Lr).flatten(1).all(dim=1)
    fact, inv = backward_errors(D, L, Linv)
    fact_r, inv_r = backward_errors(D[good], Lr[good], Linvr[good])
    err = float((L[good] - Lr[good]).abs().max())
    return {"fact": fact, "fact_plain": fact_r, "inv": inv,
            "inv_plain": inv_r, "max_abs_err": err,
            "max_rel_err": err / float(Lr[good].abs().max()),
            "blocks_the_plain_version_failed": int((~good).sum())}


def k1_f32_record(blocks, launches, factorizations, rejected, chol_linv,
                  chol_linv_reference, launch_plan):
    """Phase 12: K1 in f32 on the recorded real blocks (one band
    factorization, 11 levels): backward errors within 10x of the plain
    version's where it factors the block too, and the device times summed
    over the levels; ``rejected``: the blocks K1 and its plain version
    rejected over the solve's f32 factorizations."""
    tot, worst = {}, {}
    bound_total = 0.0
    for D in blocks:
        for k, v in backward_f32(D, chol_linv, chol_linv_reference).items():
            worst[k] = worst.get(k, 0) + v if k.startswith("blocks") \
                else max(worst.get(k, 0.0), v)
        for k, v in k1_times(D, chol_linv, chol_linv_reference, 20).items():
            tot[k] = tot.get(k, 0.0) + v
        bound_ms, bound_by = k1_bound_ms(D.shape[0], D.shape[-1], D.dtype)
        bound_total += bound_ms
    print(json.dumps({"k1_backward": "quad1000_mixed_f32", **worst}))
    assert worst["fact"] <= 10 * worst["fact_plain"], worst
    assert worst["inv"] <= 10 * worst["inv_plain"], worst
    names = ("kernel", "plain", "library")
    return {"dtype": "float32", "levels": [D.shape[0] for D in blocks],
            "n": blocks[0].shape[-1],
            "plan_344": launch_plan(64, torch.float32, 344)._asdict(),
            "launches": launches,
            "launches_per_factorization": launches / factorizations,
            "blocks_rejected": counts(rejected),
            "max_abs_err": worst["max_abs_err"],
            "max_rel_err": worst["max_rel_err"],
            "ms": tot["kernel_device_ms"], "plain_ms": tot["plain_device_ms"],
            "bound_ms": bound_total, "bound_by": bound_by,
            "library_ms": tot["library_device_ms"],
            "event_ms": {k: tot[k + "_event_ms"] for k in names}}


def opf_mixed_phase(chol_linv, chol_linv_reference, launch_plan):
    """Phase 13: opf-1000 and opf-100 with factor_dtype="mixed" in
    block_diag mode."""
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.models import opf
    from infiniteexamodels_jl_torch.solvers.block_tridiag import (
        BlockTridiagKKT)
    for S, (status, iters, objective, last32, by) in OPF_MIXED.items():
        m = opf(num_supports=S)
        backend = ExaTranscriptionBackend(timed_solver(), device="cuda",
                                          linear_solver="auto", tol=1e-6,
                                          factor_dtype="mixed",
                                          print_level=0)
        m.set_transformation_backend(backend)
        backend.build(m)
        seen, tally = [], rejections()
        res, first_s, launches, facts, by_dtype = solve_recorded(
            backend, m, chol_linv, seen, dtype=torch.float32, tally=tally)
        kkt = backend.solver.kkt
        assert type(kkt) is BlockTridiagKKT, type(kkt)
        assert (kkt.mode, kkt.nb, kkt.bs, kkt.mB) == (
            "block_diag", S + 1, 24, 6), (kkt.mode, kkt.nb)
        # K1 in f32 on the blocks of the last f32 factorization
        (D,) = seen
        back = backward_f32(D, chol_linv, chol_linv_reference)
        assert back["fact"] <= 10 * back["fact_plain"], back
        assert back["inv"] <= 10 * back["inv_plain"], back
        assert launches == facts, (launches, facts)
        assert by_dtype["k1"] == by_dtype["factor"], by_dtype
        assert by_dtype["k1"].get("float32", 0) > 0, by_dtype
        assert res.status == "first_order", res.status
        rel = abs(res.objective - objective) / abs(objective)
        assert rel <= 1e-6, (res.objective, rel)
        handover, n32, n64, ms = f32_phase(backend.solver.steps)
        print(json.dumps({
            "lowprec": f"opf-{S}", "factor_dtype": "mixed",
            "status": res.status, "iterations": res.iter,
            "objective": res.objective, "objective_rel_err": rel,
            "f32_until": handover, "f32_steps": n32, "f64_steps": n64,
            "k1_launches": launches, "by_dtype": by_dtype,
            "factorizations": facts, "k1_launches_per_factorization":
            launches / facts,
            f"plan_{S + 1}": launch_plan(24, torch.float32,
                                         S + 1)._asdict(),
            "k1_f32_last_blocks": back,
            "blocks_rejected_f32": counts(tally),
            "blocks_rejected_f64": CENSUS.last,
            "first_solve_s": first_s, "ms_per_step": ms,
            "jax_cpu_record": {"status": status, "iterations": iters,
                               "objective": objective, "f32_until": last32,
                               "by": by}}))
        del m, backend, kkt, seen


def ldl_phase():
    """Phase 14: the host LDL with the model on the card, against the band
    path, quad-200 at tol 1e-8."""
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.models import quad
    from infiniteexamodels_jl_torch.solvers import IpmSolver
    from infiniteexamodels_jl_torch.solvers.cpp_ldl import CppLdlKKT
    out = {}
    for ls in ("auto", "ldl_cpp"):
        m = quad(num_supports=200)
        backend = ExaTranscriptionBackend(IpmSolver, device="cuda",
                                          linear_solver=ls, tol=1e-8,
                                          print_level=0)
        m.set_transformation_backend(backend)
        backend.build(m)
        t0 = time.time()
        res = backend.optimize(m)
        torch.cuda.synchronize()
        secs = time.time() - t0
        assert res.status == "first_order", (ls, res.status)
        out[ls] = (res, secs, type(backend.solver.kkt).__name__)
        if ls == "ldl_cpp":
            assert type(backend.solver.kkt) is CppLdlKKT
            assert backend.model.x0.device.type == "cuda"
    band, ldl = out["auto"][0], out["ldl_cpp"][0]
    rel = abs(ldl.objective - band.objective) / abs(band.objective)
    assert rel <= 1e-8, (ldl.objective, band.objective, rel)
    print(json.dumps({
        "ldl": "quad-200", "objective_rel_to_band": rel,
        **{ls: {"kkt": kkt, "iterations": r.iter, "objective": r.objective,
                "solve_s": secs, "ms_per_iteration": 1e3 * secs / r.iter}
           for ls, (r, secs, kkt) in out.items()}}))


def checkpoint_trace_phase():
    """Phase 15: checkpoint + resume bit-identical, and a profiler trace
    naming K1, at quad-200 (f64 band) on the card."""
    import numpy as np
    from infiniteexamodels_jl_torch.models import quad
    from infiniteexamodels_jl_torch.solvers import IpmSolver
    from infiniteexamodels_jl_torch.solvers.ipm import TRACE_FILE
    from infiniteexamodels_jl_torch.transcribe import transcribe
    m, _ = transcribe(quad(num_supports=200), device="cuda")

    def solver():
        return IpmSolver(m, linear_solver="auto", tol=1e-6, print_level=0)
    full = solver().solve()
    assert full.status == "first_order" and full.iter > 4, full.iter
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "chiprun_out") as tmp:
        ckpt = os.path.join(tmp, "state.npz")
        s = solver()
        cut = s.solve(checkpoint_path=ckpt, checkpoint_every=2, max_iter=4)
        assert cut.iter == 4 and int(s.load_checkpoint(ckpt).iter) == 4
        res = s.solve(resume_from=ckpt, max_iter=3000)
        same = bool(np.array_equal(res.solution, full.solution))
        assert res.status == "first_order" and res.iter == full.iter, (
            res.status, res.iter, full.iter)
        assert same, "resumed solve differs from the uninterrupted one"
        # three iterations are enough to name K1, and keep the trace small
        t0 = time.time()
        traced = solver().solve(trace_dir=os.path.join(tmp, "trace"),
                                max_iter=3)
        trace_s = time.time() - t0
        path = os.path.join(tmp, "trace", TRACE_FILE)
        trace_bytes = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = sorted({e["name"] for e in kernels if "chol_linv" in e["name"]})
    assert traced.iter == 3 and k1, (traced.iter, len(kernels))
    print(json.dumps({
        "checkpoint": "quad-200", "iterations": full.iter,
        "resumed_from_iteration": 4, "resumed_iterations": res.iter,
        "bit_identical": same, "traced_iterations": traced.iter,
        "trace_s": trace_s,
        "trace_bytes": trace_bytes, "trace_kernel_events": len(kernels),
        "trace_k1_events": sum(1 for e in kernels
                               if "chol_linv" in e["name"]),
        "trace_k1_names": k1}))


# phase 16: the multi-device backends, 4 ranks sharing the one card
MESH_RANKS = 4
MESH_TIMEOUT_S = 120        # every collective of a rank gives up after this
# case: (builder, kwargs, kkt class, nb, nb_loc, border, objective record,
# single-card iterations (phases 4 and 9), JAX CPU iterations,
# K1 launches per factorization on every rank)
MESH_CASES = {
    "farmer-1000": ("farmer", dict(num_scenarios=1000), "ShardedScenarioKKT",
                    1000, 250, 3, FARMER1000[0], 38, FARMER1000[1], 1),
    # the band of 688 blocks, padded to 4 segments of 2^8: 8 local BCR
    # levels, then the 4-block tail (2 levels and its root) on every rank
    "quad-1000": ("quad", dict(num_supports=1000), "ShardedBandKKT", 1024,
                  256, 0, QUAD1000_OBJECTIVE, 10, 10, 8 + 2 + 1),
}


def warm_libraries(device):
    """One call of each library routine the solves use (cuBLAS batched
    matmul and triangular solve, cuSOLVER Cholesky), in both dtypes, so
    that their workspaces are allocated before a baseline is read."""
    for dt in (torch.float64, torch.float32):
        A = torch.eye(16, dtype=dt, device=device).expand(4, 16, 16)
        L, _ = torch.linalg.cholesky_ex(A.contiguous())
        torch.linalg.solve_triangular(L, A, upper=False)
        torch.matmul(A, A)
        torch.linalg.cholesky_ex(A[0].contiguous())
    torch.cuda.synchronize(device)


def cuda_bytes(obj, seen=None, depth=0):
    """Bytes of the distinct CUDA storages reachable from ``obj`` through
    tensors, lists, tuples, dicts and the attributes of the port's own
    objects (4 levels deep)."""
    seen = set() if seen is None else seen
    if torch.is_tensor(obj):
        if obj.device.type != "cuda":
            return 0
        st = obj.untyped_storage()
        if st.data_ptr() in seen:
            return 0
        seen.add(st.data_ptr())
        return st.nbytes()
    if depth > 4:
        return 0
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    elif type(obj).__module__.startswith("infiniteexamodels_jl_torch"):
        items = list(vars(obj).values()) if hasattr(obj, "__dict__") else []
    else:
        return 0
    return sum(cuda_bytes(v, seen, depth + 1) for v in items)


def memory_attribution(backend, peak):
    """A rank's device memory after its first solve, by what holds it:
    the model's plans and tables (``SimdModel``: family tables, segment-sum
    plans, bounds, starts), the KKT's plans and index tables, one iterate
    (``IpmState``), the gathered value streams of one evaluation (Jacobian
    and Hessian COO values, gradient and constraints, as every rank holds
    them whole), and one assembled K with its factorization; the rest of
    ``peak`` is temporaries."""
    solver, model = backend.solver, backend.model
    kkt = solver.kkt
    seen = set()
    out = {"model_tables": cuda_bytes(model, seen),
           "kkt_tables": cuda_bytes(kkt, seen)}
    consts = solver._compute_consts(model.theta, model)
    st = solver._init_state(model.x0, model.y0, consts)
    out["iterate"] = cuda_bytes(list(st), set())
    esize = torch.finfo(model.dtype).bits // 8
    out["gathered_streams"] = esize * (
        len(model.jac_rows_np) + len(model.hess_rows_np) + model.nvar
        + model.ncon)
    d = torch.ones(model.ncon, dtype=model.dtype, device=model.device)
    de = torch.ones(model.nvar, dtype=model.dtype, device=model.device)
    K = kkt.assemble(st.x, model.theta, st.y, 1.0, d, de)
    fac, _ = kkt.factor(K)
    out["kkt_blocks"] = cuda_bytes([K, fac], set())
    out["peak"] = peak
    out["rest"] = peak - sum(v for k, v in out.items() if k != "peak")
    return out


def mesh_rank(rank, size, tmp):
    """One rank of phase 16 (a process of its own, spawned): every case
    through ``ExaTranscriptionBackend(IpmSolver, mesh=global_mesh())``."""
    import hashlib
    import pickle

    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    from infiniteexamodels_jl_torch import models
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.parallel.distributed import (
        global_mesh, initialize)
    from infiniteexamodels_jl_torch.solvers import (band_shard,
                                                    block_tridiag,
                                                    scenario_shard)
    from infiniteexamodels_jl_torch.solvers import IpmSolver
    from infiniteexamodels_jl_torch.solvers.chol_linv import chol_linv

    initialize(backend="gloo", init_method=f"file://{tmp}/rendezvous",
               world_size=size, rank=rank, timeout=MESH_TIMEOUT_S)
    mesh = global_mesh()
    assert mesh.device == torch.device("cuda:0"), mesh.device
    # the blocks of every K1 call (each sharded module calls its own
    # import of block_tridiag._chol_linv; the replicated tail calls
    # block_tridiag's) and the factorizations, counted here
    k1 = block_tridiag._chol_linv
    calls, facts = [], [0]

    def recording(D):
        if recording.keep:
            calls.append(D.detach().clone())
            del calls[:-32]
        recording.n += 1
        return k1(D)

    def counted(cls):
        factor = cls.factor

        def f(self, K):
            facts[0] += 1
            if facts[0] == 1:
                with mesh.recording() as log:
                    out = factor(self, K)
                f.log = list(log)
                return out
            return factor(self, K)
        return f

    for mod in (block_tridiag, scenario_shard, band_shard):
        mod._chol_linv = recording
    for cls in (scenario_shard.ShardedScenarioKKT, band_shard.ShardedBandKKT):
        cls.factor = counted(cls)
    out = {"staged": sorted(mesh.staged), "backend": mesh.backend}
    warm_libraries(mesh.device)
    for tag, case in MESH_CASES.items():
        name, kw = case[0], case[1]
        gc.collect()
        torch.cuda.synchronize()
        # the baseline: after a warm call of every library routine the
        # solve uses (their workspaces), with nothing of the case built
        baseline = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        m = getattr(models, name)(**kw)
        backend = ExaTranscriptionBackend(IpmSolver, mesh=mesh,
                                          linear_solver="auto", tol=1e-6,
                                          print_level=0)
        m.set_transformation_backend(backend)
        backend.build(m)
        build_s = time.time() - t0
        rec = {}
        for run in ("first", "warm"):
            recording.n = facts[0] = chol_linv.launches = 0
            # the first solve's peak memory is read without the recording
            # of K1's inputs; the warm one records them
            recording.keep = run == "warm"
            mesh.barrier()
            t0 = time.time()
            res = backend.optimize(m)
            torch.cuda.synchronize()
            rec[run] = dict(s=time.time() - t0, iter=res.iter,
                            status=res.status, objective=res.objective,
                            launches=chol_linv.launches,
                            factorizations=facts[0],
                            calls=recording.n)
            if run == "first":
                peak = torch.cuda.max_memory_allocated() - baseline
                memory = memory_attribution(backend, peak)
        kkt = backend.solver.kkt
        # the final x, hashed; the hashes of every rank, all-gathered
        x = torch.as_tensor(res.solution)
        h = hashlib.sha256(x.numpy().tobytes()).digest()[:8]
        mine = torch.tensor([int.from_bytes(h, "little", signed=True)],
                            dtype=torch.int64, device=mesh.device)
        hashes = mesh.all_gather(mine).reshape(-1).tolist()
        # the blocks of the last factorization (this rank's K1 calls)
        per = rec["warm"]["launches"] // max(rec["warm"]["factorizations"],
                                             1)
        last = calls[-per:] if per else []
        if rank == 0:
            torch.save([D.cpu() for D in last], f"{tmp}/{tag}-blocks.pt")
        rec.update(kkt=type(kkt).__name__,
                   aligned=bool(getattr(kkt, "aligned", False)),
                   nb=kkt.nb, nb_loc=getattr(kkt, "nb_loc", None),
                   bs=kkt.bs, mB=kkt.mB, build_s=build_s,
                   shapes=[list(D.shape) for D in last],
                   factor_collectives=type(kkt).factor.log,
                   hashes=hashes, memory=memory,
                   peak_memory_above_baseline_bytes=peak)
        out[tag] = rec
        del m, backend, kkt
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def collective_totals(log):
    """{kind: [count, elements]} of a recorded collective log."""
    tot = {}
    for kind, el in log:
        c = tot.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += el
    return tot


def mesh_phase(chol_linv, chol_linv_reference, launch_plan):
    """Phase 16: farmer-1000 and quad-1000 on 4 ranks sharing the card
    over gloo; returns K1's record on the sharded paths."""
    import pickle
    import torch.multiprocessing as mp

    t_phase = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(mesh_rank, args=(MESH_RANKS, tmp), nprocs=MESH_RANKS,
                       join=False)
        deadline = time.time() + 600
        try:
            # a failing rank raises here; a hung one is killed at the limit
            while not ctx.join(timeout=5):
                if time.time() > deadline:
                    raise RuntimeError("phase 16: ranks passed 600 s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = []
        for r in range(MESH_RANKS):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        blocks = {tag: torch.load(f"{tmp}/{tag}-blocks.pt")
                  for tag in MESH_CASES}
    record = {}
    for tag, (_, _, cls, nb, nb_loc, mB, objective, card_iters, cpu_iters,
              per) in MESH_CASES.items():
        recs = [r[tag] for r in ranks]
        r0 = recs[0]
        assert (r0["kkt"], r0["aligned"], r0["nb"], r0["nb_loc"],
                r0["mB"]) == (cls, True, nb, nb_loc, mB), (tag, r0)
        for run in ("first", "warm"):
            res = r0[run]
            assert res["status"] == "first_order", (tag, run, res)
            rel = abs(res["objective"] - objective) / abs(objective)
            assert rel <= 1e-6, (tag, run, res["objective"], rel)
            for r in recs:
                # K1 launched in every factorization on every rank
                assert r[run]["launches"] == per * r[run]["factorizations"] \
                    > 0, (tag, run, r[run])
                assert r[run]["calls"] == r[run]["launches"], r[run]
        # the final iterate bit-identical on every rank
        assert len(set(r0["hashes"])) == 1, (tag, r0["hashes"])
        assert all(r["hashes"] == r0["hashes"] for r in recs)
        # K1 on the blocks of rank 0's last factorization
        shapes = r0["shapes"]
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0}
        err = rel_err = 0.0
        for i, D in enumerate(blocks[tag]):
            D = D.cuda()
            e, re_ = check_backward(f"{tag}_mesh_call{i}", D, chol_linv,
                                    chol_linv_reference)
            err, rel_err = max(err, e), max(rel_err, re_)
            t = k1_times(D, chol_linv, chol_linv_reference, 20)
            tot["ms"] += t["kernel_device_ms"]
            tot["plain_ms"] += t["plain_device_ms"]
            tot["library_ms"] += t["library_device_ms"]
            tot["bound_ms"] += k1_bound_ms(D.shape[0], D.shape[-1],
                                           D.dtype)[0]
        factor_log = collective_totals(r0["factor_collectives"])
        print(json.dumps({
            "mesh": tag, "ranks": MESH_RANKS, "backend": ranks[0]["backend"],
            "staged_through_host": ranks[0]["staged"], "kkt": cls,
            "nb": nb, "nb_loc": nb_loc, "bs": r0["bs"], "mB": mB,
            "status": r0["first"]["status"],
            "iterations": r0["first"]["iter"],
            "single_card_iterations": card_iters,
            "reference_cpu_iterations": cpu_iters,
            "objective": r0["first"]["objective"],
            "first_solve_s": [r["first"]["s"] for r in recs],
            "warm_solve_s": [r["warm"]["s"] for r in recs],
            "build_s": [r["build_s"] for r in recs],
            "k1_launches": [r["first"]["launches"] for r in recs],
            "factorizations": [r["first"]["factorizations"] for r in recs],
            "k1_launches_per_factorization": per,
            "k1_shapes_per_factorization": shapes,
            "k1_plans": [launch_plan(n, torch.float64, nb_)._asdict()
                         for nb_, n, _ in shapes],
            "collectives_per_factorization": factor_log,
            "peak_memory_above_baseline_bytes": [
                r["peak_memory_above_baseline_bytes"] for r in recs],
            "memory_by_holder": [r["memory"] for r in recs],
            "x_hashes": r0["hashes"]}))
        record[tag] = {"launches_per_rank": [r["first"]["launches"]
                                             for r in recs],
                       "launches_per_factorization": per,
                       "shapes": shapes, "max_abs_err": err,
                       "max_rel_err": rel_err, **tot,
                       "bound_by": "bytes"}
    print(json.dumps({"mesh_phase_s": time.time() - t_phase}))
    return record


# phase 17: the families no earlier phase runs, at the sizes of the
# reference's examples harness (examples/run_examples.py) and of its
# pandemic tests (tests/test_models.py).  Records: the JAX package on the
# host CPU with linear_solver="auto", tol=1e-6 -- (status, iterations,
# objective): run_examples' options (max_iter 600) for hovercraft, kinetics
# and design_3node, each slow test's options for pandemic (`python -m
# tests.cpu_records --set examples|kinetics|pandemic`).
FAMILY_RECORDS = {
    "hovercraft-101": ("first_order", 3, 0.043369306185676096),
    "kinetics-50": ("first_order", 41, 0.6202467804743852),
    "design_3node-1000": ("first_order", 9, 0.9986694387059003),
    "pandemic-51x4": ("first_order", 701, 29.13795531750876),
    "pandemic-100x8": ("acceptable", 454, 30.346450404717153),
    "pandemic-100x32": ("acceptable", 900, 31.155249208602484),
}
# kinetics-50 at tol 1e-6 ends where round-off steers it: the JAX package's
# own exact KKT routes end 1.9e-6 apart (relative).  The case is held
# within 1e-6 of the nearest of them (JAX package, host CPU, tol 1e-6,
# max_iter 600: linear_solver "auto", "dense", "ldl_cpp").
KINETICS50_ROUTES = {"auto": (41, 0.6202467804743852),
                     "dense": (31, 0.6202467178443798),
                     "ldl_cpp": (47, 0.6202478852440209)}
# cases run cut at this many iterations, their path checked and not their
# result: (100,32) in phase 17 (the band KKT with a border of 110; the
# certificate itself, 900 iterations, runs through tools/profile.py
# --certificate, PERF.md) and (100,128) in phase 18 (band 7,040 x 16 with
# a border of 110; the JAX package does not certify it)
CUT_AT = {"pandemic-100x32": 120, "pandemic-100x128": 50}
# case: (builder, its arguments, solver options, (mode, nb, bs, mB),
# K1 launches per factorization (BCR levels + 1), warm re-solve?)
FAMILY_CASES = {
    "hovercraft-101": ("hovercraft", dict(num_supports=101), {},
                       ("band", 65, 16, 0), 8, True),
    "kinetics-50": ("kinetic_control", dict(num_supports=50), {},
                    ("band", 50, 24, 0), 7, False),
    "design_3node-1000": ("design_3node", dict(num_scenarios=1000), {},
                          ("block_diag", 1000, 8, 3), 1, True),
    # test_pandemic
    "pandemic-51x4": ("pandemic", dict(num_supports=51, num_scenarios=4),
                      dict(max_iter=800), ("band", 36, 56, 0), 7, False),
    # test_pandemic_limit_cycle_escape: the reference's sweep point
    "pandemic-100x8": ("pandemic", dict(num_supports=100, num_scenarios=8),
                       dict(max_iter=600), ("band", 100, 72, 0), 8, False),
    # test_pandemic_stall_recalc_100x32: the band KKT with a border of 110
    # (the elastic cap's v_imax widens the blocks to 24)
    "pandemic-100x32": ("pandemic", dict(num_supports=100, num_scenarios=32,
                                         elastic_rho=500.0),
                        dict(max_iter=CUT_AT["pandemic-100x32"],
                             dual_init="lsq", recalc_y_stall=True),
                        ("band", 1320, 24, 110), 12, False),
    # phase 18: the sweep's largest pandemic point with run_cases' options
    # (the longest bordered band the port runs)
    "pandemic-100x128": ("pandemic", dict(num_supports=100,
                                          num_scenarios=128),
                         dict(max_iter=CUT_AT["pandemic-100x128"]),
                         ("band", 7040, 16, 110), 14, False),
}
# phase 17's longest solves, in a process of their own beside phases 13-17
BACKGROUND = ("pandemic-51x4", "pandemic-100x8")
PHASE17 = tuple(c for c in tuple(FAMILY_CASES)[:-1] if c not in BACKGROUND)


def family_checks(tag, m, res):
    """The case's own bounds: the JAX CPU objective within 1e-6 relative,
    or the bounds of the JAX package's pandemic tests, asserted -- except
    (100,8)'s iteration bound, which is returned (met or not) and printed
    beside the case."""
    import numpy as np
    obj = m.objective_value()
    if tag in CUT_AT:
        # cut: the path (band KKT with its border) is held, and the iterate
        # stays finite; not the result
        assert res.iter == CUT_AT[tag], (tag, res.iter)
        assert math.isfinite(obj) and math.isfinite(res.primal_feas)
        assert np.isfinite(np.asarray(res.solution)).all(), tag
        return {}
    status, _, objective = FAMILY_RECORDS[tag]
    assert res.status == status, (tag, res.status)
    if tag == "kinetics-50":
        rel = min(abs(obj - o) / abs(o) for _, o in KINETICS50_ROUTES.values())
        assert rel <= 1e-6, (tag, obj, rel)
        return {}
    if not tag.startswith("pandemic"):
        rel = abs(obj - objective) / abs(objective)
        assert rel <= 1e-6, (tag, obj, rel)
        return {}

    def values(name):
        return np.asarray(m.value(next(v for v in m.infinite_vars
                                        if v.name == name)))
    if tag == "pandemic-51x4":           # test_pandemic
        assert res.primal_feas <= 1e-4, res.primal_feas
        assert abs(obj - 29.137955008938995) <= 1e-3, obj
        i, u = values("i"), values("u")
        assert i.shape[1] == 4 and np.all(i <= 0.02 + 1e-5), i.max()
        assert np.all(u >= -1e-6) and np.all(u <= 0.8 + 1e-6)
        return {}
    # test_pandemic_limit_cycle_escape.  Its "fewer than 600 iterations"
    # is printed, not asserted: on this degenerate family the iteration
    # count follows round-off -- the JAX package's own solve ends at 454,
    # 529, 537 or 560 iterations under start perturbations of 1e-12
    # (tests/cpu_records.py --x0-noise), the port's at the 600 limit on the
    # CPU and on the card, with the same step as the JAX package's from
    # every state of its run (tests/torch_vs_jax_steps.py); see PERF.md
    assert res.primal_feas <= 1e-5, res.primal_feas
    assert res.dual_feas <= 1e-2, res.dual_feas
    assert abs(obj - 30.346) <= 5e-3, obj
    return {"iterations < 600": res.iter < 600}


class BorderCheck:
    """Around ``BlockTridiagKKT._schur_cholesky``: every border factor the
    card computes, held against the same S factored in f64 on the host
    (``torch.linalg.cholesky_ex``, LAPACK): the same blocks fail, and the
    card's backward error ||Ls Ls^T - S|| / ||S|| is within 10x of the
    host's (floored at n eps)."""

    def __init__(self):
        from infiniteexamodels_jl_torch.solvers.block_tridiag import (
            BlockTridiagKKT)
        self.cls = BlockTridiagKKT
        self.orig = BlockTridiagKKT._schur_cholesky
        self.calls = self.failed = 0
        self.worst = {"card": 0.0, "host": 0.0, "forward_rel": 0.0}

    def check(self, S):
        Ls = self.orig(S)
        Sh = S.detach().to(torch.float64).cpu()
        Lh, info = torch.linalg.cholesky_ex(Sh)
        Lc = Ls.detach().to(torch.float64).cpu()
        self.calls += 1
        host_ok, card_ok = int(info) == 0, bool(torch.isfinite(Lc).all())
        assert host_ok == card_ok, (self.calls, host_ok, card_ok)
        if not host_ok:
            self.failed += 1
            return Ls
        nrm = float(torch.linalg.matrix_norm(Sh))
        be = {"card": float(torch.linalg.matrix_norm(Lc @ Lc.T - Sh)) / nrm,
              "host": float(torch.linalg.matrix_norm(Lh @ Lh.T - Sh)) / nrm,
              "forward_rel": float((Lc - Lh).abs().max()
                                   / Lh.abs().max())}
        floor = S.shape[0] * torch.finfo(S.dtype).eps
        assert be["card"] <= 10 * max(be["host"], floor), (self.calls, be)
        for k, v in be.items():
            self.worst[k] = max(self.worst[k], v)
        return Ls

    def __enter__(self):
        self.cls._schur_cholesky = staticmethod(self.check)
        return self

    def __exit__(self, *exc):
        self.cls._schur_cholesky = staticmethod(self.orig)


def bordered_residual(kkt, K, seed=0):
    """||K x - r|| / ||r|| of one factor + solve of the last K the solve
    assembled, for a random r, with K applied through ``matvec``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    D = K[0]
    r = torch.randn(kkt.n, generator=g, dtype=torch.float64).to(
        device=D.device, dtype=D.dtype)
    fac, ok = kkt.factor(K)
    x = kkt.solve(fac, r)
    res = torch.linalg.vector_norm(kkt.matvec(K, x) - r)
    return bool(ok), float(res / torch.linalg.vector_norm(r))


def family_solve(tag, chol_linv):
    """One case of FAMILY_CASES on the card, its checks asserted; returns
    its line and the blocks of the last factorization of its (first)
    solve."""
    from infiniteexamodels_jl_torch import models
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.solvers import IpmSolver
    from infiniteexamodels_jl_torch.solvers.block_tridiag import (
        BlockTridiagKKT)
    name, kw, opts, shape, per, warm = FAMILY_CASES[tag]
    t0 = time.time()
    m = getattr(models, name)(**kw)
    backend = ExaTranscriptionBackend(IpmSolver, device="cuda",
                                      linear_solver="auto", tol=1e-6,
                                      print_level=0, **opts)
    m.set_transformation_backend(backend)
    backend.build(m)
    build_s = time.time() - t0
    seen, last_K = [], []
    border = BorderCheck() if shape[3] else None
    if border is not None:
        with border:
            res, first_s, launches, facts, by = solve_recorded(
                backend, m, chol_linv, seen, keep=per, last_K=last_K)
    else:
        res, first_s, launches, facts, by = solve_recorded(
            backend, m, chol_linv, seen, keep=per, last_K=last_K)
    census = CENSUS.last
    kkt = backend.solver.kkt
    assert type(kkt) is BlockTridiagKKT, (tag, type(kkt))
    assert (kkt.mode, kkt.nb, kkt.bs, kkt.mB) == shape, (
        tag, kkt.mode, kkt.nb, kkt.bs, kkt.mB)
    assert kkt.k1_launches_per_factorization() == per, tag
    # every factorization of the solve launched K1 ``per`` times, and K2
    # twice a BCR level
    assert facts > 0 and launches == per * facts, (tag, launches, facts)
    assert by["k2"] == 2 * (per - 1) * facts, (tag, by["k2"], facts)
    unmet = family_checks(tag, m, res)
    record = FAMILY_RECORDS.get(tag)
    warm_s = None
    if warm:
        res2, warm_s, _, _, _ = solve_recorded(backend, m, chol_linv)
        assert (res2.status, res2.iter) == (res.status, res.iter), (
            tag, res2.status, res2.iter)
    line = {"family": tag, "nvar": backend.model.nvar,
            "ncon": backend.model.ncon, "mode": kkt.mode, "nb": kkt.nb,
            "bs": kkt.bs, "mB": kkt.mB, "status": res.status,
            "iterations": res.iter, "objective": res.objective,
            "primal_feas": res.primal_feas, "dual_feas": res.dual_feas,
            "jax_cpu_record": record and dict(zip(
                ("status", "iterations", "objective"), record)),
            "objective_rel_err": record and abs(
                res.objective - record[2]) / abs(record[2]),
            "build_s": build_s, "first_solve_s": first_s,
            "warm_resolve_s": warm_s,
            "ms_per_iteration_first": 1e3 * first_s / max(res.iter, 1),
            "k1_launches": launches, "factorizations": facts,
            "k1_launches_per_factorization": launches / facts,
            "k2_launches": by["k2"],
            "blocks_rejected_f64": census,
            "reference_bounds_printed_not_asserted": unmet}
    if border is not None:
        ok, rel = bordered_residual(kkt, last_K[0])
        assert ok and math.isfinite(rel), (tag, ok, rel)
        line.update(border_factorizations=border.calls,
                    border_not_spd=border.failed,
                    border_backward_error=border.worst,
                    bordered_solve_backward_error=rel)
    assert len(seen) == per, (tag, len(seen))
    return line, seen


def family_record(line, seen, chol_linv, chol_linv_reference):
    """Prints a case's line; K1 against its plain version on the blocks of
    the case's last factorization (its record in the kernels line)."""
    print(json.dumps(line))
    tag, launches = line["family"], line["k1_launches"]
    rec = k1_main_path_record(seen, chol_linv, chol_linv_reference,
                              launches, tag=tag)
    return {"shapes": [list(D.shape) for D in seen], "launches": launches,
            "launches_per_factorization": len(seen),
            **{k: rec[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}


def family_worker(rank, cases, tmp):
    """The process of phase 17's ``cases`` (spawned): each solved and
    checked as in the main process, with its own f64 census; the lines,
    the blocks and the census saved for the main process."""
    sys.path.insert(0, str(ROOT))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from infiniteexamodels_jl_torch.solvers.chol_linv import chol_linv
    CENSUS.install()
    CENSUS.begin("17")
    out = {}
    for tag in cases:
        line, seen = family_solve(tag, chol_linv)
        out[tag] = (line, [D.cpu() for D in seen])
    torch.save({"cases": out,
                "census": counts(CENSUS.phases.get("17", rejections()))},
               f"{tmp}/families.pt")


class Background:
    """Cases of phase 17 in a process of their own (``family_worker``),
    started before the phases they run beside: on these host-bound solves
    the card is busy a few percent of the time."""

    def __init__(self, cases):
        import torch.multiprocessing as mp
        self.tmp = tempfile.TemporaryDirectory()
        self.t0 = time.time()
        # a daemon: it ends with this process, whatever phase fails
        self.ctx = mp.spawn(family_worker, args=(cases, self.tmp.name),
                            nprocs=1, join=False, daemon=True)

    def join(self, limit_s=1000):
        """Waits for the process (a failing case raises here, a hung one
        is killed ``limit_s`` after the start) and returns its results."""
        try:
            while not self.ctx.join(timeout=5):
                if time.time() > self.t0 + limit_s:
                    raise RuntimeError(f"phase 17: passed {limit_s} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
        out = torch.load(f"{self.tmp.name}/families.pt")
        self.tmp.cleanup()
        print(json.dumps({"background_s": time.time() - self.t0}))
        return out


def family_phase(chol_linv, chol_linv_reference, cases=PHASE17,
                 background=None):
    """Phase 17: the ``cases`` of FAMILY_CASES on the card, then those of
    ``background`` (a ``Background``), whose census joins the phase's;
    returns K1's records on their paths."""
    t_phase = time.time()
    solved = [family_solve(tag, chol_linv) for tag in cases]
    # K1's times are taken once the card is this process's alone
    if background is not None:
        out = background.join()
        solved += [(line, [D.cuda() for D in seen])
                   for line, seen in out["cases"].values()]
        CENSUS.extra[CENSUS.phase] = out["census"]
    records = {line["family"]: family_record(line, seen, chol_linv,
                                             chol_linv_reference)
               for line, seen in solved}
    print(json.dumps({"family_phase_s": time.time() - t_phase}))
    return records


# phase 18: the reference's ESCAPE34 sweep points (SURVEY.md §6; its
# run_cases harness, benchmarks/run_cases.py, and the port's
# infiniteexamodels_jl_torch.tools.run_cases).  Records: the JAX package on
# the host CPU with run_cases' options (linear_solver="auto", tol=1e-6, the
# default max_iter) -- (status, iterations, objective, nvar, ncon), by
# `python -m tests.cpu_records --set escape34`.  Phase 18 runs quad-4000,
# quad-16000 and the opf points; the rest run through tools/run_cases.py
# (PERF.md).
ESCAPE34_RECORDS = {
    "quad-2000": ("first_order", 11, 568.7941963097398, 87978, 79978),
    "quad-4000": ("first_order", 10, 568.7745032138869, 175978, 159978),
    "quad-8000": ("first_order", 10, 568.7654566958233, 351978, 319978),
    "quad-16000": ("first_order", 12, 568.761122769237, 703978, 639978),
    "opf-2000": ("first_order", 24, 5744.482319094539, 48024, 68028),
    "opf-4000": ("first_order", 15, 5744.482320161422, 96024, 136028),
    "opf-8000": ("first_order", 15, 5744.482319908405, 192024, 272028),
    "pandemic-25x4": ("acceptable", 1956, 28.568798018928202, 1155, 1260),
    "pandemic-50x4": ("first_order", 306, 29.088918210131872, 1980, 2160),
    "pandemic-100x4": ("acceptable", 1062, 29.746498048935724, 3630,
                       3960),
    # as phase 17's record: max_iter does not bind
    "pandemic-100x8": ("acceptable", 454, 30.346450404717153, 7150, 7920),
}
# quad supports -> band blocks of 64 (the band KKT, no border)
ESCAPE34_QUAD = {4000: 2750, 16000: 11000}
ESCAPE34_OPF = (2000, 4000, 8000)
# opf-2000's endgame runs over blocks indefinite at round-off level, which
# K1's f64 pivot test rejects (ROADMAP 3.7): a cap far above its count
# (JAX CPU 24) turns a relapse into the crawl it replaced into a failure
# within minutes, where the default max_iter would take most of an hour
ESCAPE34_MAX_ITER = {2000: 150}


def escape34_phase(chol_linv, chol_linv_reference):
    """Phase 18: quad-4000 and quad-16000 through the band KKT, K1 on
    quad-16000's recorded blocks, opf-2000, opf-4000 and opf-8000 through
    the scenario KKT, and pandemic (100,128) cut at 50 iterations; returns K1's
    records on quad-16000's and (100,128)'s paths, and K2's record (the
    second of the kernels line) on quad-16000's."""
    from infiniteexamodels_jl_torch.models import opf, quad
    from infiniteexamodels_jl_torch.tools.k1_sweep import bcr_levels
    t_phase = time.time()
    record = {}
    for n, nb in ESCAPE34_QUAD.items():
        tag = f"quad-{n}"
        status, iters, objective, nvar, ncon = ESCAPE34_RECORDS[tag]
        seen = [] if n == 16000 else None
        k2_seen = [] if n == 16000 else None
        per = len(bcr_levels(nb))
        assert per == math.ceil(math.log2(nb)) + 1, (nb, per)
        line = structured_solve(tag, quad(num_supports=n),
                                (status, iters, objective),
                                ("band", nb, 64, 0), per, chol_linv, seen,
                                keep=per, k2_seen=k2_seen)
        assert (line["nvar"], line["ncon"]) == (nvar, ncon), line
    launches = line["k1_launches"]
    # K2 on the inputs of the same factorization's 14 levels (each level's
    # odd blocks are K1's launches but the root)
    odd = [c[0].shape[0] for c in k2_seen]
    assert odd == list(bcr_levels(11000)[:-1]), odd
    k2_record = k2_main_path_record(k2_seen, line["k2_launches"])
    del k2_seen
    # K1 on the blocks of quad-16000's last band factorization
    assert tuple(D.shape[0] for D in seen) == bcr_levels(11000), [
        D.shape for D in seen]
    rec = k1_main_path_record(seen, chol_linv, chol_linv_reference,
                              launches, tag="quad16000")
    record["quad16000"] = {"shapes": [list(D.shape) for D in seen],
                           "launches_per_factorization": len(seen),
                           **{k: rec[k] for k in (
                               "launches", "max_abs_err", "max_rel_err",
                               "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "event_ms")}}
    del seen
    for S in ESCAPE34_OPF:
        status, iters, objective, nvar, ncon = ESCAPE34_RECORDS[f"opf-{S}"]
        line = structured_solve(f"opf-{S}", opf(num_supports=S),
                                (status, iters, objective),
                                ("block_diag", S + 1, 24, 6), 1, chol_linv,
                                max_iter=ESCAPE34_MAX_ITER.get(S))
        assert (line["nvar"], line["ncon"]) == (nvar, ncon), line
    record.update(family_phase(chol_linv, chol_linv_reference,
                               cases=("pandemic-100x128",)))
    print(json.dumps({"escape34_phase_s": time.time() - t_phase}))
    return record, k2_record


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from infiniteexamodels_jl_torch.models import quad
    from infiniteexamodels_jl_torch.solvers.chol_linv import (
        chol_linv, chol_linv_reference, launch_plan)
    from infiniteexamodels_jl_torch.utils import host_build
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
    logs = build_all(["chol_linv", "bcr_level"])
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log.strip()}")
    build_s = time.time() - t0
    host_build.build("ldl")
    print(json.dumps({"build_s": build_s,
                      "host_build_s": time.time() - t0 - build_s}))

    # 3. K1 against its plain version
    worst = k1_phase(chol_linv, chol_linv_reference, launch_plan)
    print(json.dumps({"k1_worst_rel_err": worst}))

    # K1's f64 census from here on: every f64 call of the solves on this
    # card also through the plain version's pivot test, tallied by phase
    CENSUS.install()

    # 4. the main path: quad-1000 on the card, one K1 launch per BCR
    # level; the warm re-solve records the blocks of every K1 call, the
    # last 11 being its last band factorization (a late iteration)
    CENSUS.begin("4")
    seen = []
    line = structured_solve("quad-1000", quad(num_supports=1000),
                            ("first_order", 10, QUAD1000_OBJECTIVE),
                            ("band", 688, 64, 0), len(QUAD1000_LEVELS),
                            chol_linv, seen, keep=len(QUAD1000_LEVELS))
    assert tuple(D.shape[0] for D in seen) == QUAD1000_LEVELS, [
        D.shape for D in seen]
    CENSUS.report()

    # 5. determinism: two quad-200 solves, every iterate bit-identical
    CENSUS.begin("5")
    determinism("quad-200", lambda: quad(num_supports=200))
    CENSUS.report()

    # 6. K1 on the recorded quad-1000 blocks; the kernels line
    record = k1_main_path_record(seen, chol_linv, chol_linv_reference,
                                 line["k1_launches"])
    del seen

    # 7.-10. scenario mode
    record["opf16000"] = scenario_phases(chol_linv, chol_linv_reference)

    # 11.-13. the low-precision step sets
    CENSUS.begin("11")
    blocks, (launches32, facts32, rejected) = lowprec_quad_phase(chol_linv)
    CENSUS.report()
    record["f32"] = k1_f32_record(blocks, launches32, facts32, rejected,
                                  chol_linv, chol_linv_reference,
                                  launch_plan)
    del blocks
    # phase 17's two longest solves start here, beside phases 13-17
    background = Background(BACKGROUND)
    # 13. opf "mixed"
    CENSUS.begin("13")
    opf_mixed_phase(chol_linv, chol_linv_reference, launch_plan)
    CENSUS.report()

    # 14. the host LDL; 15. checkpoint/resume and the profiler trace
    CENSUS.begin("14")
    ldl_phase()
    CENSUS.report()
    CENSUS.begin("15")
    checkpoint_trace_phase()
    CENSUS.report()

    # 16. the multi-device backends: 4 ranks on the card
    record["sharded"] = mesh_phase(chol_linv, chol_linv_reference,
                                   launch_plan)

    # 17. the families no earlier phase runs
    CENSUS.begin("17")
    record["families"] = family_phase(chol_linv, chol_linv_reference,
                                      background=background)
    CENSUS.report()

    # 18. the reference's ESCAPE34 sweep points
    CENSUS.begin("18")
    record["escape34"], k2_record = escape34_phase(chol_linv,
                                                   chol_linv_reference)
    CENSUS.report()
    record["blocks_rejected_f64"] = CENSUS.reports

    print(json.dumps({"elapsed_s": time.time() - t_start}))
    print(card_line())        # again here: the head of a long log is cut
    print(json.dumps({"kernels": [record, k2_record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
