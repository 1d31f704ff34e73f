"""The one traffic generator: reads a mix (``traffic/<mix>.json``) and
yields the requests of a closed loop (one client that waits for each answer
before the next request).

A mix names the request kind, ``resolve`` (the built model re-solved from
its start values) or ``build`` (a new model built, transcribed, given a
solver and solved), and ``set_parameters``: whether each request first sets
the configuration's published parameter functions again through
``set_parameter_value``, the in-place path by which a tracking loop hands
the model each new reference.  Every request of a mix is the same work at
the published data; the seed draws the configuration's scenarios (where the
model has them) and the answers judged.
"""
from __future__ import annotations

import itertools

SEED_MODULUS = 2 ** 63


def request(mix, index):
    """Request ``index`` of the mix: ``{"index", "kind",
    "set_parameters"}``."""
    return {"index": index, "kind": mix["request"],
            "set_parameters": bool(mix.get("set_parameters", False))}


def warmup(mix):
    """The set-up's one request: the mix's own."""
    return request(mix, -1)


def requests(mix, start=0):
    """The endless closed-loop stream from request ``start`` on."""
    for i in itertools.count(start):
        yield request(mix, i)
