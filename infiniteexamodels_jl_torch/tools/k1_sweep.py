"""K1's device time under other launch configurations than its plan's.

    python -m infiniteexamodels_jl_torch.tools.k1_sweep [--factorizations]

Calls the kernel's C entry point directly with each configuration and
prints one JSON object per line: the card's name and power limit, then for
each case the configuration, the device milliseconds per call (a CUDA
graph of 20 launches, replayed between CUDA events, so the host's cost of
issuing them is left out) and the kernel's error against the plain
version.  The cases are the choices ``launch_plan`` makes: the cluster
size of the cluster path (4, 8, 16 CTAs per block at n = 128 ... 512) and
the threads of the CTA path (128, 256 at the quad-1000 band shapes,
n = 64; 32 ... 256 at n = 8 ... 64 with 16 and with 2,048 blocks,
``planned`` marking the plan's own choice).  Two rounds, to show the
spread.  Exits non-zero when CUDA is absent.

With ``--factorizations`` it times instead, with the plan's own
configuration, one factorization at each of chip_smoke's K1 shapes:
quad-1000's 11 BCR levels of 64 (f64 and f32), the (16,001, 24) scenario
blocks (f64 and f32) and quad-16000's 15 levels of 64 (f64), summed over
the levels, three rounds; so two trees' kernels (``PYTHONPATH``) compare
within one call.
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys

import torch

from ..solvers import chol_linv as k1


def graph_ms(fn, reps):
    """Device milliseconds per call with the host out of the way: ``reps``
    calls captured in one CUDA graph, replayed three times between two
    CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                      # warm-up, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def launcher(D, plan=None):
    """A call that launches K1 on ``D`` into preallocated outputs through
    the C entry point (no wrapper, no launch count), with ``plan`` or the
    wrapper's own plan.  Returns ``(call, L, Linv)``."""
    nb, n = D.shape[0], D.shape[-1]
    plan = plan or k1.launch_plan(
        n, D.dtype, nb,
        torch.cuda.get_device_properties(D.device).multi_processor_count)
    fn = k1._kernel(D.dtype)
    L, X = torch.empty_like(D), torch.empty_like(D)
    ok = torch.empty(nb, dtype=torch.int32, device=D.device)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(D.data_ptr(), L.data_ptr(), X.data_ptr(), ok.data_ptr(),
                 nb, n, k1._PATH_IDS[plan.path], plan.ctas, plan.threads,
                 plan.smem_bytes, plan.ld, stream)
        if err != 0:
            raise RuntimeError(f"chol_linv launch failed: CUDA error {err}")

    return call, L, X


def _spd(nb, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(nb, n, n, generator=g, device="cuda", dtype=dtype)
    eye = torch.eye(n, device="cuda", dtype=dtype)
    return (A @ A.transpose(1, 2) / n + eye).contiguous()


def _time(D, plan, reps=20):
    """Device ms per call of the kernel launched with ``plan`` (a CUDA
    graph of ``reps`` launches), and its largest error in L^{-1} relative
    to the plain version's."""
    call, _, X = launcher(D, plan)
    call()
    _, Xr, _ = k1.chol_linv_reference(D)
    rel = float((X - Xr).abs().max() / Xr.abs().max())
    return graph_ms(call, reps), rel


def bcr_levels(nb):
    """The blocks of each K1 launch of one band factorization of ``nb``
    blocks: the odd blocks of every BCR level, then the root."""
    out = []
    while nb > 1:
        out.append(nb // 2)
        nb = (nb + 1) // 2
    return tuple(out) + (1,)


FACTORIZATIONS = {      # case: (blocks of each launch, n, dtype)
    "quad-1000 f64": (bcr_levels(688), 64, torch.float64),
    "quad-1000 f32": (bcr_levels(688), 64, torch.float32),
    "opf-16000 f64": ((16001,), 24, torch.float64),
    "opf-16000 f32": ((16001,), 24, torch.float32),
    "quad-16000 f64": (bcr_levels(11000), 64, torch.float64),
}


def factorizations():
    """Device ms of one factorization per FACTORIZATIONS case (the plan's
    configuration, summed over its launches), three rounds."""
    for rnd in range(3):
        for case, (levels, n, dt) in FACTORIZATIONS.items():
            ms = sum(_time(_spd(nb, n, dt, seed=4 + i), None)[0]
                     for i, nb in enumerate(levels))
            print(json.dumps({"round": rnd, "factorization": case,
                              "launches": len(levels), "device_ms": ms}))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--factorizations", action="store_true",
                    help="time one factorization at chip_smoke's shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_sweep: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}))
    if args.factorizations:
        factorizations()
        return 0
    for rnd in range(2):
        for nb, n, dt in [(2, 512, torch.float64), (2, 512, torch.float32),
                          (8, 256, torch.float64), (8, 176, torch.float64),
                          (8, 128, torch.float64)]:
            D = _spd(nb, n, dt, seed=1)
            for ctas in (4, 8, 16):
                plan = k1.LaunchPlan("cluster", ctas, k1.MAX_THREADS, 0, n)
                ms, rel = _time(D, plan)
                print(json.dumps({"round": rnd, "shape": [nb, n, n],
                                  "dtype": str(dt), "path": "cluster",
                                  "ctas_per_block": ctas, "device_ms": ms,
                                  "rel_err": rel}))
        for nb in (1, 43, 172, 344):
            D = _spd(nb, 64, torch.float64, seed=2)
            base = k1.launch_plan(64, torch.float64, nb)
            for threads in (128, 256):
                ms, rel = _time(D, base._replace(threads=threads))
                print(json.dumps({"round": rnd, "shape": [nb, 64, 64],
                                  "dtype": "torch.float64", "path": "cta",
                                  "threads": threads, "device_ms": ms,
                                  "rel_err": rel}))
        for n, nb, dt in itertools.product(
                (8, 16, 24, 32, 40, 64), (16, 2048),
                (torch.float64, torch.float32)):
            D = _spd(nb, n, dt, seed=3)
            plan = k1.launch_plan(n, dt, nb)
            for threads in k1.CTA_THREADS:
                ms, rel = _time(D, plan._replace(threads=threads))
                print(json.dumps({"round": rnd, "shape": [nb, n, n],
                                  "dtype": str(dt), "path": "cta",
                                  "threads": threads,
                                  "planned": threads == plan.threads,
                                  "device_ms": ms, "rel_err": rel}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
