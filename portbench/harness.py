"""One run of one cell: set-up, the measured window, the per-layer readers,
then the reference's judgement once the program's state is freed.

The window is a closed loop: whole requests back to back, each waiting
for the answer of the one before; it closes at the end of the first
request that ends after ``seconds``.  A request that does not end
``first_order`` counts as failed.  With ``traced`` the window's first two
requests run under ``torch.profiler`` (``trace``), with K1's launches
recorded in the first; the readers of host times leave those two out,
and the window runs on until it holds an untraced request.
The end-to-end metrics come from untraced runs only.
"""
from __future__ import annotations

import contextlib
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import drive, generate, host, judge, registry, trace as tr

SEED_MODULUS = generate.SEED_MODULUS


class Run:
    """What the metric readers read: the window's records, the trace's
    summary, K1's launches, the live program (until the readers are done)
    and the table of peaks."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self._memo = {}

    def memo(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    @property
    def on_card(self):
        return self.device.type == "cuda"

    @property
    def untraced(self):
        """The window's requests that ran without the profiler, whose host
        times the profiler did not slow."""
        return [r for r in self.records if not r.get("traced")]


def card_line():
    """``name, power.limit`` of the card, as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def run(cell, seed, seconds, traced, device="cuda", t0=None):
    """Returns (result, notes): the result line's object and what goes on
    an earlier line."""
    t0 = time.perf_counter() if t0 is None else t0
    config, mix = cell["config"], cell["mix"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    model_seed = int(seed) % SEED_MODULUS
    if on_card:
        torch.cuda.init()
        baseline = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    system = drive.System(config, dev, model_seed)
    if mix["request"] == "resolve":
        system.build()
    warm = generate.warmup(mix)         # the cell's own shape, once
    system.request(warm["kind"], warm["set_parameters"])
    setup_s = time.perf_counter() - t0

    records, answers, launches = [], [], []
    traces = {}
    probes = [host.probe(dev)]
    h0 = host.mark()
    w0 = time.perf_counter()
    for req in generate.requests(mix):
        k = len(records)
        with contextlib.ExitStack() as stack:
            if traced and k < 2:
                # request 0: the card's activity alone; request 1: the
                # host's operations too, for the idle gaps' labels
                acts = [ProfilerActivity.CUDA] if on_card else []
                if k == 1 or not on_card:
                    acts = [ProfilerActivity.CPU] + acts
                traces[k] = stack.enter_context(profile(activities=acts))
                if k == 0:
                    stack.enter_context(drive.recording_k1(launches))
                stack.enter_context(record_function(tr.WINDOW))
            with record_function("portbench.request"):
                rec, ans = system.request(req["kind"], req["set_parameters"])
            rec["traced"] = traced and k < 2
        records.append(rec)
        answers.append(ans)
        if (time.perf_counter() - w0 >= seconds
                and not (traced and len(records) <= 2)):
            break
    window_s = time.perf_counter() - w0
    h1 = host.mark()
    probes.append(host.probe(dev))
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    summary = None
    if traced:
        summary = tr.device_summary(
            traces[0].profiler.kineto_results.events())
        summary["window_s"] = records[0]["wall_s"]
        summary["idle_gaps"] = (
            tr.idle_gaps(traces[1].profiler.kineto_results.events())
            if 1 in traces else [])
        traces.clear()

    r = Run(cell=cell, config=config, mix=mix, seed=seed, device=dev,
            setup_s=setup_s, window_s=window_s, records=records,
            trace=summary, k1_launches=launches, system=system,
            peaks=registry.peaks(),
            device_name=torch.cuda.get_device_name(dev) if on_card else None)
    metrics = {}
    for m in cell["metrics"]:
        v = registry.reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    system.release()
    del r

    picked = judge.sample(len(answers), seed)
    values = judge.worst(
        [judge.readings(config, answers[i], model_seed)
         for i in picked], [rec["status"] for rec in records])
    correct, checks = judge.compare(config, values)

    result = {
        "correct": correct,
        "attempted": len(records),
        "failed": sum(rec["status"] != "first_order" for rec in records),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if traced:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {
            "device_ops": tr.top_kernels(summary["kernels_s"]),
            "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    notes = {
        "card": card_line() if on_card else None,
        "memory_above_baseline_bytes":
            int(peak - baseline) if on_card else None,
        "setup_s": setup_s, "window_s": window_s,
        "requests": [{k: rec[k] for k in ("status", "iter", "wall_s")}
                     for rec in records],
        "judged": picked,
        "readings": values,
        "host": dict(host.between(h0, h1), probes=probes),
    }
    if on_card:
        notes["host"]["card_numa"] = host.card_numa(dev)
    return result, notes


def mean(values):
    values = [v for v in values if v is not None and np.isfinite(v)]
    return float(np.mean(values)) if values else None
