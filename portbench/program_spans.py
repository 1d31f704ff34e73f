"""The program's own span totals and counters of the window's last
request, read as per-step metrics.

The port's solver returns, on each result, ``spans`` (``{path: {"calls",
"s", "self_s"}}``, a path being the names of the open spans joined with
``/``) and ``counts`` (``{name: int}``).  The readers take the result of
the window's last request (``run.system.solver().results``; in a
``build`` cell, whose models end with their requests, the copy that
``drive.System`` keeps of the last one), which a traced run leaves
untraced: its window runs on until it holds one.  "Per
step" is over that request's ``iter``, as ``ipm.step_ms`` has it.

Every span at or under ``ipm.step`` falls in one share of the step by its
own name (``share``), so the shares' self times add up to the step.  A
program without spans (an older commit) gives ``None`` for every metric.
"""
from __future__ import annotations

STEP = "ipm.step"
AD_SWEEPS = "ad.sweeps"          # every span named ``ad.*``
IPM_SELF = "ipm.self"            # every span that no entry below names
SHARES = {
    "kkt.assemble": "kkt.assemble_self",
    "kkt.factor": "kkt.factor",
    "k1.chol_linv": "kkt.factor",
    "kkt.solve": "kkt.solve",
    "ipm.host_sync": "ipm.host_sync",
}


def share(name):
    """The share of the step that the span ``name`` belongs to."""
    return AD_SWEEPS if name.startswith("ad.") else SHARES.get(name,
                                                                IPM_SELF)


def last_result(run):
    """The result of the window's last request, or ``None`` where the
    program keeps no spans."""
    solver = run.system.solver()
    res = (run.system.last_build if solver is None
           else getattr(solver, "results", None))
    if res is None or not getattr(res, "spans", None) or not res.iter:
        return None
    return res


def in_step(res):
    """``(name, totals)`` of each span at or under ``ipm.step``."""
    for path, tot in res.spans.items():
        parts = path.split("/")
        if STEP in parts:
            yield parts[-1], tot


def step_shares_ms(res):
    """Milliseconds per step of self time in each share of the step."""
    out = dict.fromkeys({AD_SWEEPS, IPM_SELF, *SHARES.values()}, 0.0)
    for name, tot in in_step(res):
        out[share(name)] += tot["self_s"]
    return {k: 1e3 * v / res.iter for k, v in out.items()}


def step_ms(res, name):
    """Milliseconds per step of self time in the spans ``name``."""
    return 1e3 * sum(t["self_s"] for n, t in in_step(res)
                     if n == name) / res.iter


def calls_per_step(res, name):
    """Calls per step of the spans ``name`` under ``ipm.step``."""
    return sum(t["calls"] for n, t in in_step(res) if n == name) / res.iter


def share_reader(key):
    """A metric reader of one share of the step."""
    def read(run):
        res = last_result(run)
        return None if res is None else step_shares_ms(res)[key]
    return read
