"""The two-stage stochastic AC-OPF of ESCAPE34/opf.jl on a MATPOWER case,
and the first-order check of one answer.

Network data as PowerModels prepares it (per unit, quadratic costs,
``calc_thermal_limits!``), from the frozen case text beside this file.
First stage: ``va0, vm0, pg0, qg0, p0, q0`` (the polar AC power flow,
ACP); second stage: the same over ``N`` scenarios of bus-load
perturbations ``theta ~ MvNormal(0, diag((0.1 [pd; qd])^2 + 1e-12))``
added to the bus balances; ramping rows ``|pg0 - pg| <= 0.1 (pmax -
pmin)`` and ``|qg0 - qg| <= 0.1 (qmax - qmin)`` couple them.  The
objective is the first stage's generation cost.  The thermal rows read
``p^2 + q^2 <= rate_a``, as ESCAPE34/opf.jl writes them.

The scenarios are drawn here from the configuration's seed by the rule
the configuration states (numpy's ``default_rng(seed)``,
``multivariate_normal``).  Every row of this NLP is a row the user wrote,
so the answer carries the dual of each (in the order of the published
model: per stage the reference buses, each branch's four flows, its angle
difference and its two thermal limits, each bus's two balances; then each
generator's two ramps) and the duals of every variable bound.
"""
from __future__ import annotations

import math
import os
import re

import numpy as np
import torch

from . import kkt

CASE_DIR = os.path.dirname(os.path.abspath(__file__))


def _matrix(text, name):
    m = re.search(rf"mpc\.{name}\s*=\s*\[(.*?)\]", text, re.S)
    rows = []
    for line in m.group(1).splitlines():
        line = line.split("%")[0].strip().rstrip(";")
        if line:
            rows.append([float(v) for v in line.split()])
    return np.array(rows)


def network(case_file):
    """Per-unit network data of a MATPOWER case."""
    with open(os.path.join(CASE_DIR, case_file)) as fh:
        text = fh.read()
    base = float(re.search(r"mpc\.baseMVA\s*=\s*([\d.eE+-]+)", text).group(1))
    bus, gen = _matrix(text, "bus"), _matrix(text, "gen")
    branch, cost = _matrix(text, "branch"), _matrix(text, "gencost")
    ids = [int(i) for i in bus[:, 0]]
    pos = {i: k for k, i in enumerate(ids)}
    net = dict(
        ids=ids, ref=[pos[int(r[0])] for r in bus if int(r[1]) == 3],
        pd=bus[:, 2] / base, qd=bus[:, 3] / base,
        gs=bus[:, 4] / base, bs=bus[:, 5] / base,
        vmax=bus[:, 11], vmin=bus[:, 12],
        gbus=[pos[int(b)] for b in gen[:, 0]],
        pmax=gen[:, 8] / base, pmin=gen[:, 9] / base,
        qmax=gen[:, 3] / base, qmin=gen[:, 4] / base)
    # quadratic cost c2 p^2 + c1 p + c0 in per-unit power
    c = cost[:, 4:7]
    net["cost"] = c * np.array([base ** 2, base, 1.0])
    lines = []
    for li, r in enumerate(branch, start=1):
        f, t = pos[int(r[0])], pos[int(r[1])]
        y2 = r[2] ** 2 + r[3] ** 2
        ratio = r[8] if r[8] != 0 else 1.0
        shift = math.radians(r[9])
        angmin = math.radians(r[11] if r[11] != 0 else -60.0)
        angmax = math.radians(r[12] if r[12] != 0 else 60.0)
        rate = r[5] / base if r[5] > 0 else 2.0
        # calc_thermal_limits!: the largest flow the voltage limits allow
        vf, vt = net["vmax"][f], net["vmax"][t]
        c_max = math.sqrt(vf ** 2 + vt ** 2 - 2 * vf * vt * math.cos(
            max(abs(angmin), abs(angmax))))
        rate = min(rate, max(vf, vt) * c_max / math.sqrt(y2))
        tr, ti = ratio * math.cos(shift), ratio * math.sin(shift)
        lines.append(dict(
            li=li, f=f, t=t, g=r[2] / y2, b=-r[3] / y2, tr=tr, ti=ti,
            ttm=tr * tr + ti * ti, b_fr=r[4] / 2.0, b_to=r[4] / 2.0,
            rate=rate, angmin=angmin, angmax=angmax))
    net["lines"] = lines
    return net


def scenarios(net, seed, count):
    """The second stage's load perturbations, ``(count, 2 nbus)``."""
    cov = (0.1 * np.concatenate([net["pd"], net["qd"]])) ** 2 + 1e-12
    rng = np.random.default_rng(seed)
    return rng.multivariate_normal(np.zeros(len(cov)), np.diag(cov),
                                   size=count)


def _names(net, stage):
    """Variable names and bounds of one stage, in the published order."""
    s = "0" if stage == 1 else ""
    ids, out = net["ids"], []
    for k, i in enumerate(ids):
        out.append((f"va{s}_{i}", -np.inf, np.inf))
    for k, i in enumerate(ids):
        out.append((f"vm{s}_{i}", net["vmin"][k], net["vmax"][k]))
    for g in range(len(net["gbus"])):
        out.append((f"pg{s}_{g + 1}", net["pmin"][g], net["pmax"][g]))
    for g in range(len(net["gbus"])):
        out.append((f"qg{s}_{g + 1}", net["qmin"][g], net["qmax"][g]))
    for kind in ("p", "q"):
        for ln in net["lines"]:
            fi, ti = ids[ln["f"]], ids[ln["t"]]
            for a in ((ln["li"], fi, ti), (ln["li"], ti, fi)):
                out.append((f"{kind}{s}_{a}", -ln["rate"], ln["rate"]))
    return out


def _stage_rows(net, v, s, theta):
    """(body, lo, hi) of one stage's rows, in the published order."""
    ids, rows = net["ids"], []
    va = [v[f"va{s}_{i}"] for i in ids]
    vm = [v[f"vm{s}_{i}"] for i in ids]
    for k in net["ref"]:
        rows.append((va[k], 0.0, 0.0))
    flow = {}
    for ln in net["lines"]:
        f, t = ln["f"], ln["t"]
        af, at = (ln["li"], ids[f], ids[t]), (ln["li"], ids[t], ids[f])
        p_f, q_f = v[f"p{s}_{af}"], v[f"q{s}_{af}"]
        p_t, q_t = v[f"p{s}_{at}"], v[f"q{s}_{at}"]
        g, b, tr, ti, ttm = ln["g"], ln["b"], ln["tr"], ln["ti"], ln["ttm"]
        vff = vm[f] * vm[t]
        cf, sf = torch.cos(va[f] - va[t]), torch.sin(va[f] - va[t])
        ct, st = torch.cos(va[t] - va[f]), torch.sin(va[t] - va[f])
        rows.append((p_f - (g / ttm * vm[f] ** 2
                            + (-g * tr + b * ti) / ttm * vff * cf
                            + (-b * tr - g * ti) / ttm * vff * sf), 0.0, 0.0))
        rows.append((q_f - (-(b + ln["b_fr"]) / ttm * vm[f] ** 2
                            - (-b * tr - g * ti) / ttm * vff * cf
                            + (-g * tr + b * ti) / ttm * vff * sf), 0.0, 0.0))
        rows.append((p_t - (g * vm[t] ** 2
                            + (-g * tr - b * ti) / ttm * vff * ct
                            + (-b * tr + g * ti) / ttm * vff * st), 0.0, 0.0))
        rows.append((q_t - (-(b + ln["b_to"]) * vm[t] ** 2
                            - (-b * tr + g * ti) / ttm * vff * ct
                            + (-g * tr - b * ti) / ttm * vff * st), 0.0, 0.0))
        rows.append((va[f] - va[t], ln["angmin"], ln["angmax"]))
        rows.append((p_f ** 2 + q_f ** 2, -np.inf, ln["rate"]))
        rows.append((p_t ** 2 + q_t ** 2, -np.inf, ln["rate"]))
        flow.setdefault(f, []).append((p_f, q_f))
        flow.setdefault(t, []).append((p_t, q_t))
    nb = len(ids)
    for k in range(nb):
        pg = [v[f"pg{s}_{g + 1}"] for g, gb in enumerate(net["gbus"])
              if gb == k]
        qg = [v[f"qg{s}_{g + 1}"] for g, gb in enumerate(net["gbus"])
              if gb == k]
        p_rhs = sum(pg) - net["pd"][k] - net["gs"][k] * vm[k] ** 2
        q_rhs = sum(qg) - net["qd"][k] + net["bs"][k] * vm[k] ** 2
        if theta is not None:
            p_rhs = p_rhs + theta[:, k]
            q_rhs = q_rhs + theta[:, nb + k]
        rows.append((sum(p for p, _ in flow[k]) - p_rhs, 0.0, 0.0))
        rows.append((sum(q for _, q in flow[k]) - q_rhs, 0.0, 0.0))
    return rows


def residuals(inputs, answer):
    """``primal_inf``, ``dual_inf``, ``compl`` and ``obj_rel`` of one
    answer."""
    net = network(inputs["case"])
    N = inputs["num_supports"]
    theta = torch.tensor(scenarios(net, inputs["seed"], N))
    variables = _names(net, 1) + _names(net, 2)
    v, bounds = {}, {}
    for name, lo, hi in variables:
        val = np.asarray(answer["values"][name], dtype=np.float64)
        if val.size not in (1, N):
            raise ValueError(f"answer {name} has {val.size} values")
        v[name] = torch.tensor(val.reshape(-1), requires_grad=True)
        bounds[name] = (lo, hi)

    f = sum(c[0] * v[f"pg0_{g + 1}"] ** 2 + c[1] * v[f"pg0_{g + 1}"] + c[2]
            for g, c in enumerate(net["cost"])).sum()
    rows = _stage_rows(net, v, "0", None) + _stage_rows(net, v, "", theta)
    for g in range(len(net["gbus"])):
        dp = 0.1 * (net["pmax"][g] - net["pmin"][g])
        dq = 0.1 * (net["qmax"][g] - net["qmin"][g])
        rows.append((v[f"pg0_{g + 1}"] - v[f"pg_{g + 1}"], -dp, dp))
        rows.append((v[f"qg0_{g + 1}"] - v[f"qg_{g + 1}"], -dq, dq))
    duals = answer["duals"]
    if len(duals) != len(rows):
        raise ValueError(f"{len(duals)} duals for {len(rows)} rows")

    primal, compl, lag, lams = 0.0, 0.0, f, []
    nrow = 0
    for (body, lo, hi), lam in zip(rows, duals):
        g = body.detach().numpy()
        lam = np.broadcast_to(np.asarray(lam, dtype=np.float64), g.shape)
        lams.append(lam)
        nrow += g.size
        primal = max(primal, kkt.range_violation(g, lo, hi))
        if lo != hi:
            compl = max(compl, kkt.range_complementarity(g, lo, hi, lam))
        lag = lag - (torch.tensor(lam) * body).sum()
    grads = torch.autograd.grad(lag, [v[n] for n, _, _ in variables])
    dual, zs = 0.0, []
    for (name, lo, hi), grad in zip(variables, grads):
        x = v[name].detach().numpy()
        zl, zu = answer["bound_duals"].get(name, (0.0, 0.0))
        zl = np.broadcast_to(np.asarray(zl, dtype=np.float64), x.shape)
        zu = np.broadcast_to(np.asarray(zu, dtype=np.float64), x.shape)
        zs += [zl, zu]
        primal = max(primal, kkt.range_violation(x, lo, hi))
        if np.isfinite(lo):
            compl = max(compl, float(np.max(np.abs(zl * (x - lo)))))
        if np.isfinite(hi):
            compl = max(compl, float(np.max(np.abs(zu * (hi - x)))))
        dual = max(dual, float(np.abs(grad.numpy() - zl + zu).max()))
    s_d = kkt.dual_scale(lams + zs, nrow + sum(x.size for x in zs) // 2)
    return {"primal_inf": primal, "dual_inf": dual / s_d, "compl": compl,
            "obj_rel": kkt.relative_gap(answer["objective"],
                                        float(f.detach()))}
