"""Two-stage stochastic AC-OPF (reference ESCAPE34/opf.jl): deterministic
first-stage AC-OPF coupled by ramping limits to a second stage over
MvNormal bus-load perturbations (num_supports scenarios); the scenario axis
is the block-diagonal structure of the KKT with a first-stage arrowhead."""
from __future__ import annotations

import numpy as np

from ..modeling import InfiniteModel, mvnormal, sin, cos
from .matpower import parse_matpower, build_ref, CASE3, CASE3_LMBD


def opf(case_text=None, seed=0, num_supports=100, backend=None):
    ref = build_ref(parse_matpower(case_text or CASE3_LMBD))
    bus, gen, branch = ref["bus"], ref["gen"], ref["branch"]
    arcs = ref["arcs"]

    nbus = len(bus)
    bus_ids = sorted(bus)
    n_th = nbus * 2
    pd = np.array([bus[i]["pd"] for i in bus_ids])
    qd = np.array([bus[i]["qd"] for i in bus_ids])
    covar = (0.1 * np.concatenate([pd, qd]))**2 + 1e-12

    m = InfiniteModel(backend, seed=seed)

    # first-stage variables
    va0 = {i: m.variable(f"va0_{i}") for i in bus_ids}
    vm0 = {i: m.variable(f"vm0_{i}", lb=bus[i]["vmin"], ub=bus[i]["vmax"],
                         start=1.0) for i in bus_ids}
    pg0 = {g: m.variable(f"pg0_{g}", lb=gen[g]["pmin"], ub=gen[g]["pmax"])
           for g in gen}
    qg0 = {g: m.variable(f"qg0_{g}", lb=gen[g]["qmin"], ub=gen[g]["qmax"])
           for g in gen}
    p0 = {a: m.variable(f"p0_{a}", lb=-branch[a[0]]["rate_a"],
                        ub=branch[a[0]]["rate_a"]) for a in arcs}
    q0 = {a: m.variable(f"q0_{a}", lb=-branch[a[0]]["rate_a"],
                        ub=branch[a[0]]["rate_a"]) for a in arcs}

    # second-stage uncertainty + recourse variables
    th = m.infinite_parameter("th", dist=mvnormal(np.zeros(n_th), covar),
                              num_supports=num_supports)
    va = {i: m.variable(f"va_{i}", deps=(th,)) for i in bus_ids}
    vm = {i: m.variable(f"vm_{i}", deps=(th,), lb=bus[i]["vmin"],
                        ub=bus[i]["vmax"], start=1.0) for i in bus_ids}
    pg = {g: m.variable(f"pg_{g}", deps=(th,), lb=gen[g]["pmin"],
                        ub=gen[g]["pmax"]) for g in gen}
    qg = {g: m.variable(f"qg_{g}", deps=(th,), lb=gen[g]["qmin"],
                        ub=gen[g]["qmax"]) for g in gen}
    p = {a: m.variable(f"p_{a}", deps=(th,), lb=-branch[a[0]]["rate_a"],
                       ub=branch[a[0]]["rate_a"]) for a in arcs}
    q = {a: m.variable(f"q_{a}", deps=(th,), lb=-branch[a[0]]["rate_a"],
                       ub=branch[a[0]]["rate_a"]) for a in arcs}

    m.minimize(sum(gen[g]["cost"][0] * pg0[g]**2
                   + gen[g]["cost"][1] * pg0[g]
                   + gen[g]["cost"][2] for g in gen))

    def ac_constraints(va_, vm_, pg_, qg_, p_, q_, stage):
        for i in ref["ref_buses"]:
            m.constraint(va_[i] == 0)
        for li, br in branch.items():
            fi, ti_ = br["f_bus"], br["t_bus"]
            f_idx, t_idx = (li, fi, ti_), (li, ti_, fi)
            g_, b_ = br["g"], br["b"]
            tr, ti = br["tr"], br["ti"]
            ttm = br["ttm"]
            dvaf = va_[fi] - va_[ti_]
            dvat = va_[ti_] - va_[fi]
            vff = vm_[fi] * vm_[ti_]
            m.constraint(
                p_[f_idx] ==
                (g_ + br["g_fr"]) / ttm * vm_[fi]**2
                + (-g_ * tr + b_ * ti) / ttm * (vff * cos(dvaf))
                + (-b_ * tr - g_ * ti) / ttm * (vff * sin(dvaf)))
            m.constraint(
                q_[f_idx] ==
                -(b_ + br["b_fr"]) / ttm * vm_[fi]**2
                - (-b_ * tr - g_ * ti) / ttm * (vff * cos(dvaf))
                + (-g_ * tr + b_ * ti) / ttm * (vff * sin(dvaf)))
            m.constraint(
                p_[t_idx] ==
                (g_ + br["g_to"]) * vm_[ti_]**2
                + (-g_ * tr - b_ * ti) / ttm * (vff * cos(dvat))
                + (-b_ * tr + g_ * ti) / ttm * (vff * sin(dvat)))
            m.constraint(
                q_[t_idx] ==
                -(b_ + br["b_to"]) * vm_[ti_]**2
                - (-b_ * tr + g_ * ti) / ttm * (vff * cos(dvat))
                + (-g_ * tr - b_ * ti) / ttm * (vff * sin(dvat)))
            m.constraint(dvaf, lb=br["angmin"], ub=br["angmax"])
            m.constraint(p_[f_idx]**2 + q_[f_idx]**2 <= br["rate_a"])
            m.constraint(p_[t_idx]**2 + q_[t_idx]**2 <= br["rate_a"])
        for k, i in enumerate(bus_ids):
            pbal = sum(p_[a] for a in ref["bus_arcs"][i])
            qbal = sum(q_[a] for a in ref["bus_arcs"][i])
            pg_sum = sum(pg_[g] for g in ref["bus_gens"][i])
            qg_sum = sum(qg_[g] for g in ref["bus_gens"][i])
            p_rhs = pg_sum - bus[i]["pd"] - bus[i]["gs"] * vm_[i]**2
            q_rhs = qg_sum - bus[i]["qd"] + bus[i]["bs"] * vm_[i]**2
            if stage == 2:
                p_rhs = p_rhs + th[k]
                q_rhs = q_rhs + th[nbus + k]
            m.constraint(pbal == p_rhs)
            m.constraint(qbal == q_rhs)

    ac_constraints(va0, vm0, pg0, qg0, p0, q0, stage=1)
    ac_constraints(va, vm, pg, qg, p, q, stage=2)

    # ramping limits couple the stages (the arrowhead, ESCAPE34/opf.jl:268)
    for g in gen:
        dp = 0.1 * (gen[g]["pmax"] - gen[g]["pmin"])
        dq = 0.1 * (gen[g]["qmax"] - gen[g]["qmin"])
        m.constraint(pg0[g] - pg[g], lb=-dp, ub=dp)
        m.constraint(qg0[g] - qg[g], lb=-dq, ub=dq)
    return m


def opf_static(case_text=None, backend=None):
    """Deterministic single-period AC-OPF in the standard pglib/PowerModels
    formulation (true apparent-power limit ``p^2 + q^2 <= rate_a^2``, raw
    case ratings).  This is the EXTERNAL correctness anchor for the AC-OPF
    family: on ``CASE3_LMBD`` the optimum must reproduce the published
    pglib-opf base-case objective 5812.64 $/h, a value computed by
    independent solvers (Ipopt) outside this repo."""
    ref = build_ref(parse_matpower(case_text or CASE3_LMBD),
                    thermal_limits=False)
    bus, gen, branch = ref["bus"], ref["gen"], ref["branch"]
    arcs = ref["arcs"]
    bus_ids = sorted(bus)

    m = InfiniteModel(backend)
    va = {i: m.variable(f"va_{i}") for i in bus_ids}
    vm = {i: m.variable(f"vm_{i}", lb=bus[i]["vmin"], ub=bus[i]["vmax"],
                        start=1.0) for i in bus_ids}
    pg = {g: m.variable(f"pg_{g}", lb=gen[g]["pmin"], ub=gen[g]["pmax"])
          for g in gen}
    qg = {g: m.variable(f"qg_{g}", lb=gen[g]["qmin"], ub=gen[g]["qmax"])
          for g in gen}
    p = {a: m.variable(f"p_{a}", lb=-branch[a[0]]["rate_a"],
                       ub=branch[a[0]]["rate_a"]) for a in arcs}
    q = {a: m.variable(f"q_{a}", lb=-branch[a[0]]["rate_a"],
                       ub=branch[a[0]]["rate_a"]) for a in arcs}

    m.minimize(sum(gen[g]["cost"][0] * pg[g]**2 + gen[g]["cost"][1] * pg[g]
                   + gen[g]["cost"][2] for g in gen))

    for i in ref["ref_buses"]:
        m.constraint(va[i] == 0)
    for li, br in branch.items():
        fi, ti_ = br["f_bus"], br["t_bus"]
        f_idx, t_idx = (li, fi, ti_), (li, ti_, fi)
        g_, b_ = br["g"], br["b"]
        tr, ti = br["tr"], br["ti"]
        ttm = br["ttm"]
        dvaf = va[fi] - va[ti_]
        dvat = va[ti_] - va[fi]
        vff = vm[fi] * vm[ti_]
        m.constraint(
            p[f_idx] == (g_ + br["g_fr"]) / ttm * vm[fi]**2
            + (-g_ * tr + b_ * ti) / ttm * (vff * cos(dvaf))
            + (-b_ * tr - g_ * ti) / ttm * (vff * sin(dvaf)))
        m.constraint(
            q[f_idx] == -(b_ + br["b_fr"]) / ttm * vm[fi]**2
            - (-b_ * tr - g_ * ti) / ttm * (vff * cos(dvaf))
            + (-g_ * tr + b_ * ti) / ttm * (vff * sin(dvaf)))
        m.constraint(
            p[t_idx] == (g_ + br["g_to"]) * vm[ti_]**2
            + (-g_ * tr - b_ * ti) / ttm * (vff * cos(dvat))
            + (-b_ * tr + g_ * ti) / ttm * (vff * sin(dvat)))
        m.constraint(
            q[t_idx] == -(b_ + br["b_to"]) * vm[ti_]**2
            - (-b_ * tr + g_ * ti) / ttm * (vff * cos(dvat))
            + (-g_ * tr - b_ * ti) / ttm * (vff * sin(dvat)))
        m.constraint(dvaf, lb=br["angmin"], ub=br["angmax"])
        m.constraint(p[f_idx]**2 + q[f_idx]**2 <= br["rate_a"]**2)
        m.constraint(p[t_idx]**2 + q[t_idx]**2 <= br["rate_a"]**2)
    for i in bus_ids:
        pbal = sum(p[a] for a in ref["bus_arcs"][i])
        qbal = sum(q[a] for a in ref["bus_arcs"][i])
        pg_sum = sum(pg[g] for g in ref["bus_gens"][i])
        qg_sum = sum(qg[g] for g in ref["bus_gens"][i])
        m.constraint(pbal == pg_sum - bus[i]["pd"] - bus[i]["gs"] * vm[i]**2)
        m.constraint(qbal == qg_sum - bus[i]["qd"] + bus[i]["bs"] * vm[i]**2)
    return m
