"""Structured per-phase timers (SURVEY.md §5: replaces the reference's
post-hoc solver-log parsing, ESCAPE34/utils.jl:3-33, with first-class
metrics)."""
from __future__ import annotations

import time
from contextlib import contextmanager


class PhaseTimers:
    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextmanager
    def phase(self, name):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {k: {"total_s": round(v, 4), "count": self.counts[k]}
                for k, v in self.totals.items()}
