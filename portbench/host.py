"""What the host did during a run, for the notes line: the CPUs the process
may use, the card's NUMA node and its CPUs, the CPUs' clock as the kernel
reports it, the load average, and over the window the share of CPU time
the hypervisor gave to others (steal), the share the machine was busy, and
the main thread's involuntary context switches; and two probes of the
host's speed, taken just before and just after the window: a fixed loop of
Python and the host's time per launch of a tiny operation on the card.
Host-bound times drift between runs; the probes say whether a slow run
was a slow host (a sandboxed host may report no load, steal or switches).
"""
from __future__ import annotations

import os
import threading
import time


def _read(path):
    try:
        with open(path) as fh:
            return fh.read()
    except OSError:
        return None


def _cpu_times():
    text = _read("/proc/stat")
    if not text:
        return None
    return [int(x) for x in text.splitlines()[0].split()[1:9]]


def _switches():
    text = _read(f"/proc/self/task/{threading.get_native_id()}/status")
    if text is None:
        return None
    for line in text.splitlines():
        if line.startswith("nonvoluntary_ctxt_switches"):
            return int(line.split(":")[1])
    return None


def _mhz():
    text = _read("/proc/cpuinfo") or ""
    mhz = [float(ln.split(":")[1]) for ln in text.splitlines()
           if ln.startswith("cpu MHz")]
    return sum(mhz) / len(mhz) if mhz else None


def card_numa(device):
    """The card's NUMA node and that node's CPUs (None where unknown)."""
    try:
        import torch
        props = torch.cuda.get_device_properties(device)
        bus = "%04x:%02x:%02x.0" % (props.pci_domain_id, props.pci_bus_id,
                                    props.pci_device_id)
    except (AttributeError, RuntimeError, AssertionError):
        return None, None
    node = _read(f"/sys/bus/pci/devices/{bus}/numa_node")
    node = int(node) if node is not None else None
    cpus = (_read(f"/sys/devices/system/node/node{node}/cpulist")
            if node is not None and node >= 0 else None)
    return node, cpus.strip() if cpus else None


def mark():
    """Counters at one moment."""
    load = _read("/proc/loadavg")
    return {"cpu": _cpu_times(), "switches": _switches(), "mhz": _mhz(),
            "load1": float(load.split()[0]) if load else None}


def between(a, b):
    """What the host did between two marks."""
    out = {"mhz": [a["mhz"], b["mhz"]], "load1": [a["load1"], b["load1"]],
           "affinity": sorted(os.sched_getaffinity(0))}
    d = ([y - x for x, y in zip(a["cpu"], b["cpu"])]
         if a["cpu"] and b["cpu"] else [])
    if sum(d) > 0:
        total = sum(d)
        out["steal_pct"] = 100.0 * d[7] / total
        out["busy_pct"] = 100.0 * (total - d[3] - d[4] - d[7]) / total
    if a["switches"] is not None and b["switches"] is not None:
        out["involuntary_switches"] = b["switches"] - a["switches"]
    return out


def probe(device):
    """``python_loop_ms``: 300,000 turns of a plain Python loop;
    ``launch_us``: the host's time per launch of 4,000 in-place adds on a
    16-element tensor of ``device``, synchronised at both ends."""
    import torch

    t = time.perf_counter()
    acc = 0
    for i in range(300000):
        acc += i * i % 7
    loop_ms = 1e3 * (time.perf_counter() - t)
    x = torch.zeros(16, device=device)
    sync = (torch.cuda.synchronize if x.device.type == "cuda"
            else (lambda: None))
    sync()
    t = time.perf_counter()
    for _ in range(4000):
        x.add_(1.0)
    sync()
    return {"python_loop_ms": loop_ms,
            "launch_us": 1e6 * (time.perf_counter() - t) / 4000}
