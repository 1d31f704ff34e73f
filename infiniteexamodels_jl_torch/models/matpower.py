"""Minimal MATPOWER ``.m`` case parser + network data preparation.

Replaces the reference's PowerModels.jl usage (ESCAPE34/opf.jl:7-34:
parse_file, standardize_cost_terms!, calc_thermal_limits!, build_ref).
Parses the mpc.bus/gen/branch/gencost matrices and derives the arc/admittance
quantities the AC-OPF formulation needs.
"""
from __future__ import annotations

import math
import re


def _parse_matrix(text, name):
    mstart = re.search(rf"mpc\.{name}\s*=\s*\[", text)
    if mstart is None:
        return []
    body = text[mstart.end():]
    body = body[:body.index("]")]
    rows = []
    for line in body.splitlines():
        line = line.split("%")[0].strip().rstrip(";")
        if not line:
            continue
        rows.append([float(v) for v in line.replace(",", " ").split()])
    return rows


def parse_matpower(text):
    """Parse a MATPOWER case string -> dict of raw tables + baseMVA."""
    base = re.search(r"mpc\.baseMVA\s*=\s*([\d.eE+-]+)", text)
    return {
        "baseMVA": float(base.group(1)) if base else 100.0,
        "bus": _parse_matrix(text, "bus"),
        "gen": _parse_matrix(text, "gen"),
        "branch": _parse_matrix(text, "branch"),
        "gencost": _parse_matrix(text, "gencost"),
    }


def build_ref(case, thermal_limits=True):
    """Derive the network reference structure (PowerModels build_ref
    analogue): per-unit loads/limits, branch admittances, tap ratios, arcs,
    bus incidence maps.

    ``thermal_limits`` applies the PowerModels ``calc_thermal_limits!``
    step the reference pipeline runs (ESCAPE34/opf.jl:32): each branch's
    per-unit rate is capped at ``|y| * max(vmax_f, vmax_t) * c_max`` with
    ``c_max = sqrt(vmax_f^2 + vmax_t^2 - 2 vmax_f vmax_t cos(theta_max))``,
    which replaces placeholder ratings (pglib's 9000 MVA) by the largest
    physically attainable flow."""
    baseMVA = case["baseMVA"]
    buses, gens, branches = {}, {}, {}
    ref_buses = []
    for row in case["bus"]:
        i = int(row[0])
        buses[i] = dict(
            bus_type=int(row[1]), pd=row[2] / baseMVA, qd=row[3] / baseMVA,
            gs=row[4] / baseMVA, bs=row[5] / baseMVA,
            vmax=row[11], vmin=row[12])
        if int(row[1]) == 3:
            ref_buses.append(i)
    for gi, row in enumerate(case["gen"], start=1):
        cost = case["gencost"][gi - 1] if gi - 1 < len(case["gencost"]) \
            else [2, 0, 0, 3, 0, 1, 0]
        ncost = int(cost[3])
        coeffs = cost[4:4 + ncost]
        # standardize to quadratic (c2, c1, c0) in per-unit MW
        c = [0.0] * (3 - len(coeffs)) + list(coeffs)
        c2, c1, c0 = c[-3], c[-2], c[-1]
        gens[gi] = dict(
            bus=int(row[0]),
            pmax=row[8] / baseMVA, pmin=row[9] / baseMVA,
            qmax=row[3] / baseMVA, qmin=row[4] / baseMVA,
            cost=(c2 * baseMVA**2, c1 * baseMVA, c0))
    arcs = []
    for li, row in enumerate(case["branch"], start=1):
        f, t_ = int(row[0]), int(row[1])
        r, x, bch = row[2], row[3], row[4]
        rate_a = row[5] / baseMVA if row[5] > 0 else 2.0
        ratio = row[8] if row[8] != 0 else 1.0
        shift = math.radians(row[9])
        y2 = r * r + x * x
        g, b = r / y2, -x / y2
        tr, ti = ratio * math.cos(shift), ratio * math.sin(shift)
        angmin = math.radians(row[11] if row[11] != 0 else -60.0)
        angmax = math.radians(row[12] if row[12] != 0 else 60.0)
        if thermal_limits:
            y_mag = 1.0 / math.sqrt(y2)
            vmax_f = buses[f]["vmax"]
            vmax_t = buses[t_]["vmax"]
            theta_max = max(abs(angmin), abs(angmax))
            c_max = math.sqrt(vmax_f**2 + vmax_t**2
                              - 2 * vmax_f * vmax_t * math.cos(theta_max))
            rate_a = min(rate_a, y_mag * max(vmax_f, vmax_t) * c_max)
        branches[li] = dict(
            f_bus=f, t_bus=t_, g=g, b=b, tr=tr, ti=ti,
            ttm=tr * tr + ti * ti,
            g_fr=0.0, b_fr=bch / 2.0, g_to=0.0, b_to=bch / 2.0,
            rate_a=rate_a,
            angmin=angmin,
            angmax=angmax)
        arcs.append((li, f, t_))
        arcs.append((li, t_, f))
    bus_arcs = {i: [] for i in buses}
    for a in arcs:
        bus_arcs[a[1]].append(a)
    bus_gens = {i: [] for i in buses}
    for gi, g in gens.items():
        bus_gens[g["bus"]].append(gi)
    return dict(baseMVA=baseMVA, bus=buses, gen=gens, branch=branches,
                arcs=arcs, bus_arcs=bus_arcs, bus_gens=bus_gens,
                ref_buses=ref_buses)


# The pglib-opf case3_lmbd network data (public dataset, keyed in from the
# published case: B.C. Lesieutre, D.K. Molzahn, A.R. Borden, C.L. DeMarco,
# "Examining the limits of the application of semidefinite programming to
# power flow problems", Allerton 2011; pglib-opf repository).  The reference
# downloads exactly this file at runtime (ESCAPE34/opf.jl:13-21).  The
# checked-in text is validated by an external anchor: the published pglib
# base-case AC-OPF objective 5812.64 $/h, reproduced by ``opf_static`` in
# tests/test_models.py.
CASE3_LMBD = """
function mpc = pglib_opf_case3_lmbd
mpc.version = '2';
mpc.baseMVA = 100.0;
mpc.bus = [
    1  3  110.0  40.0  0.0  0.0  1  1.0  0.0  240.0  1  1.1  0.9;
    2  2  110.0  40.0  0.0  0.0  1  1.0  0.0  240.0  1  1.1  0.9;
    3  2  95.0   50.0  0.0  0.0  1  1.0  0.0  240.0  1  1.1  0.9;
];
mpc.gen = [
    1  1000.0  0.0  1000.0  -1000.0  1.0  100.0  1  2000.0  0.0;
    2  1000.0  0.0  1000.0  -1000.0  1.0  100.0  1  2000.0  0.0;
    3  0.0     0.0  1000.0  -1000.0  1.0  100.0  1  0.0     0.0;
];
mpc.gencost = [
    2  0.0  0.0  3  0.110000  5.000000  0.000000;
    2  0.0  0.0  3  0.085000  1.200000  0.000000;
    2  0.0  0.0  3  0.000000  0.000000  0.000000;
];
mpc.branch = [
    1  3  0.065  0.62  0.45  9000.0  0.0  0.0  0.0  0.0  1  -30.0  30.0;
    3  2  0.025  0.75  0.70  50.0    0.0  0.0  0.0  0.0  1  -30.0  30.0;
    1  2  0.042  0.90  0.30  9000.0  0.0  0.0  0.0  0.0  1  -30.0  30.0;
];
"""

# A synthetic 3-bus case with the same schema (kept as a second fixture for
# parser/formulation tests).
CASE3 = """
function mpc = case3
mpc.version = '2';
mpc.baseMVA = 100.0;
mpc.bus = [
    1  3  110.0  40.0  0.0  0.0  1  1.0  0.0  240.0  1  1.1  0.9;
    2  2  110.0  40.0  0.0  0.0  1  1.0  0.0  240.0  1  1.1  0.9;
    3  2  95.0   50.0  0.0  0.0  1  1.0  0.0  240.0  1  1.1  0.9;
];
mpc.gen = [
    1  150.0  0.0  250.0  -250.0  1.0  100.0  1  600.0  0.0;
    2  100.0  0.0  250.0  -250.0  1.0  100.0  1  500.0  0.0;
    3  80.0   0.0  250.0  -250.0  1.0  100.0  1  400.0  0.0;
];
mpc.branch = [
    1  2  0.065  0.62  0.45  250.0  0.0  0.0  0.0  0.0  1  -30.0  30.0;
    2  3  0.025  0.75  0.70  200.0  0.0  0.0  0.0  0.0  1  -30.0  30.0;
    1  3  0.042  0.90  0.30  220.0  0.0  0.0  0.0  0.0  1  -30.0  30.0;
];
mpc.gencost = [
    2  0.0  0.0  3  0.11  5.0  0.0;
    2  0.0  0.0  3  0.085  1.2  0.0;
    2  0.0  0.0  3  0.1225  1.0  0.0;
];
"""
