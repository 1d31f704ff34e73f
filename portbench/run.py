"""Run one cell of the benchmark once on the CUDA card.

    python3 -m portbench.run --workload quad-16000.resolve --seed 7 \\
        --seconds 30 --trace 0

Prints, on standard output, a line with the card and the window's requests,
then the result as the last line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics untraced, its per-layer metrics
with ``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number the reference compared beside its limit,
which also end standard error.  Exits non-zero, printing no result, when
the card is missing, or when JAX or the JAX package is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "infiniteexamodels_jl_tpu")


def loaded_forbidden():
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every kernel cache inside the checkout, at a fixed path (the port
    # builds K1 into its own _build/ there; these catch any later Triton
    # or extension build, which this file cannot then be edited to add)
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")

    from portbench import registry

    cell = registry.cell(args.workload, trace=bool(args.trace), root=ROOT)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2

    from portbench import harness

    result, notes = harness.run(cell, args.seed, args.seconds,
                                bool(args.trace), device="cuda", t0=T0)
    found = loaded_forbidden()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("portbench: " + json.dumps(notes), flush=True)
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
