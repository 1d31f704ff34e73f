"""The readings that the limits of ``correct`` are set from: the program's
answers on many seeds, and the control's, in one process.

    python3 -m portbench.control --workload quad-16000.resolve \\
        --seeds 11 12 13 [--fault grad_sign] [--device cuda]

For each seed one request of the cell's kind is made as a run makes it,
on that seed's inputs (the scenarios drawn from it, where the model has
them); the model is built once when it does not depend on the seed, else
once per seed.  Each answer is judged by the reference twice: as the
program returned it (the lower readings, or with ``--fault`` the fault's)
and rounded to float32, the best any float32 computation could hand back
(the control, the upper readings).  Prints one JSON line per seed and a
last line with, for each number, the largest reading, the smallest control
reading and their ratio.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys

import torch

from . import drive, faults, generate, judge, registry


def readings(cell, seeds, device, fault=None):
    config, mix = cell["config"], cell["mix"]
    req = generate.request(mix, 0)
    shared = None
    with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
        for seed in seeds:
            model_seed = int(seed) % generate.SEED_MODULUS
            if config.get("seed_kwarg") or shared is None:
                system = drive.System(config, torch.device(device),
                                      model_seed)
                if mix["request"] == "resolve":
                    system.build()
                shared = system
            rec, ans = shared.request(req["kind"], req["set_parameters"])
            sound = judge.readings(config, ans, model_seed)
            f32 = judge.readings(config, judge.to_float32(ans), model_seed)
            if config.get("seed_kwarg"):
                shared.release()
                shared = None
            yield {"seed": seed, "status": rec["status"], "iter": rec["iter"],
                   "wall_s": rec["wall_s"], "sound": sound, "f32": f32}


def summary(lines):
    names = sorted(set().union(*(ln["sound"] for ln in lines)))
    out = {}
    for k in names:
        lower = max(ln["sound"][k] for ln in lines)
        upper = min(ln["f32"][k] for ln in lines)
        out[k] = {"lower": lower, "upper": upper,
                  "ratio": upper / lower if lower > 0 else math.inf}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.cell(args.workload)
    lines = []
    for ln in readings(cell, args.seeds, args.device, args.fault):
        print(json.dumps(ln), flush=True)
        lines.append(ln)
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "readings": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
