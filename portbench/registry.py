"""Finds everything of a cell by name from ``BENCHMARK.json``: the
configuration's file, the traffic mix ``traffic/<mix>.json``, and one
reader ``metrics/<metric>.py`` for each metric the cell reports."""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def reader(name):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench, workload, trace):
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    def listed(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (listed(m) if "workloads" in m else m["moves"] in moved)]


def mix(name):
    """The traffic mix ``traffic/<name>.json``."""
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def config(name):
    """The configuration ``configs/<name>.json``."""
    return _json(os.path.join(HERE, "configs", f"{name}.json"))


def cell(workload, trace=False, root=ROOT):
    """Everything a run of ``workload`` needs, as one dict."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {
        "workload": entry,
        "config": _json(os.path.join(root, conf["file"])),
        "mix": mix(entry["traffic"]),
        "metrics": cell_metrics(bench, workload, trace),
    }


def peaks():
    """The table of peaks by card name (``peaks.json``)."""
    return _json(os.path.join(HERE, "peaks.json"))
