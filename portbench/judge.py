"""Decides ``correct``: each answer of the window judged by the plain
reference, each number compared with its limit from the configuration.

The numbers (the worst over the answers judged):

- ``not_first_order``: window answers whose status is not
  ``first_order`` (limit 0);
- ``primal_inf``: the largest violation of a row or bound, evaluated by
  the reference at the answer's primal point;
- ``dual_inf``: the largest entry of the Lagrangian's gradient at the
  answer, with the answer's duals (and the reference's own for rows that
  transcription adds), scaled as the solver scales it;
- ``compl``: the largest product of a dual and its slack (inequalities
  and bounds);
- ``obj_rel``: the reported objective against the reference's objective
  at the answer's point.
"""
from __future__ import annotations

import importlib
import math

import numpy as np

MAX_JUDGED = 4


def reference_inputs(config, model_seed):
    inputs = dict(config["inputs"])
    if "parameter_functions" in config:
        inputs["tracking"] = config["parameter_functions"]
    if config.get("seed_kwarg"):
        inputs["seed"] = model_seed
    return inputs


def readings(config, answer, model_seed):
    """The reference's numbers for one answer; an answer the reference
    cannot read (wrong lengths, missing rows) reads infinite."""
    ref = importlib.import_module(
        f"portbench.reference.{config['reference']}")
    try:
        return ref.residuals(reference_inputs(config, model_seed),
                             answer)
    except (ValueError, KeyError, IndexError, TypeError):
        return {k: math.inf for k in config["limits"]
                if k != "not_first_order"}


def sample(n, seed):
    """Indices of the answers judged: all, or ``MAX_JUDGED`` drawn from
    the seed."""
    if n <= MAX_JUDGED:
        return list(range(n))
    rng = np.random.default_rng((int(seed) % 2 ** 63, 2 ** 62))
    return sorted(rng.choice(n, MAX_JUDGED, replace=False).tolist())


def worst(all_readings, statuses):
    out = {"not_first_order": float(sum(s != "first_order"
                                        for s in statuses))}
    for r in all_readings:
        for k, v in r.items():
            v = float(v)
            if math.isnan(v):
                v = math.inf
            out[k] = max(out.get(k, 0.0), v)
    return out


def compare(config, values):
    """(correct, checks): each number beside its limit."""
    checks = {k: {"value": values.get(k, math.inf), "limit": lim}
              for k, lim in config["limits"].items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def to_float32(answer):
    """The answer as a float32 computation would hand it back at best:
    every number rounded to float32."""
    def r(a):
        return np.asarray(a, dtype=np.float32).astype(np.float64)

    return {
        "status": answer["status"],
        "objective": float(np.float32(answer["objective"])),
        "values": {k: r(v) for k, v in answer["values"].items()},
        "derivatives": {k: r(v) for k, v in answer["derivatives"].items()},
        "duals": [r(v) for v in answer["duals"]],
        "bound_duals": {k: (r(a), r(b))
                        for k, (a, b) in answer["bound_duals"].items()},
    }
