"""The system under test, driven through the port's public entry points.

A configuration names a model function of ``infiniteexamodels_jl_torch.
models``, its keyword arguments, the keyword that takes the seed (if the
model draws scenarios), and the backend's solver options.  A request is a
re-solve of the built model (``resolve``) or a new model built,
transcribed, given a solver and solved (``build``); where the mix says so,
the published tracking references are set again first, through
``set_parameter_value`` on the model's parameter functions, the in-place
path of the reference's ``set_parameter!``.  The
answer is read back through the model's ``value``, ``dual`` and the
backend's ``domain_duals``: every variable and derivative at every
support, the dual of every row the user wrote, the bound duals.

The program is imported inside the functions, never at import time.
"""
from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

PACKAGE = "infiniteexamodels_jl_torch"


def tracking_function(spec, horizon):
    """The parameter function for one tracking reference (the same
    formula as ``reference.quad.tracking``)."""
    a = float(spec["amplitude"])
    if spec["form"] == "sin":
        c, ph = float(spec["cycles"]), float(spec["phase"])
        return lambda tv: a * math.sin(2.0 * math.pi * c * tv / horizon + ph)
    if spec["form"] == "ramp":
        return lambda tv: a * (tv / horizon)
    raise ValueError(f"unknown tracking form {spec['form']!r}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    """One configuration of the port on one device."""

    def __init__(self, config, device, seed):
        from infiniteexamodels_jl_torch import models
        from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
        from infiniteexamodels_jl_torch import solvers

        self.config = config
        self.device = torch.device(device)
        self.seed = seed
        self.model_fn = getattr(models, config["model"])
        self.backend_type = ExaTranscriptionBackend
        opts = dict(config["backend"])
        self.solver_type = getattr(solvers, opts.pop("solver"))
        self.solver_options = opts
        self.model = self.backend = None
        # the last ``build`` request's ``iter``, ``spans`` and ``counts``:
        # plain numbers, so that no model outlives its request
        self.last_build = None

    # -- set-up and requests -------------------------------------------
    def new_model(self):
        kwargs = dict(self.config["kwargs"])
        if self.config.get("seed_kwarg"):
            kwargs[self.config["seed_kwarg"]] = self.seed
        return self.model_fn(**kwargs)

    def set_parameters(self, model):
        """Set each published tracking reference on its parameter
        function."""
        horizon = self.config["inputs"]["horizon"]
        funcs = {p.name: p for p in model.pfuncs}
        for name, spec in self.config["parameter_functions"].items():
            model.set_parameter_value(funcs[name],
                                      tracking_function(spec, horizon))

    def attach(self, model):
        backend = self.backend_type(self.solver_type, device=self.device,
                                    **self.solver_options)
        model.set_transformation_backend(backend)
        return backend

    def build(self):
        """Build, transcribe and keep the model the ``resolve`` requests
        re-solve."""
        self.model = self.new_model()
        self.backend = self.attach(self.model)
        self.backend.build(self.model)

    def request(self, kind, set_parameters=False):
        """One request; returns (record, answer)."""
        rec = {}
        t0 = time.perf_counter()
        if kind == "build":
            with record_function("portbench.transcribe"):
                model = self.new_model()
                if set_parameters:
                    self.set_parameters(model)
                backend = self.attach(model)
                backend.build(model)
                _sync(self.device)
            rec["transcribe_s"] = time.perf_counter() - t0
        elif kind == "resolve":
            model, backend = self.model, self.backend
            if set_parameters:
                with record_function("portbench.set_parameters"):
                    self.set_parameters(model)
        else:
            raise ValueError(f"unknown request kind {kind!r}")
        t1 = time.perf_counter()
        with record_function("portbench.optimize"):
            res = backend.optimize(model)
            _sync(self.device)
        rec["optimize_s"] = time.perf_counter() - t1
        with record_function("portbench.answer"):
            answer = read_answer(model, backend, res)
        rec.update(status=res.status, iter=int(res.iter),
                   solve_time=float(res.solve_time),
                   step_total=float(res.timers.get("step_total", np.nan)),
                   wall_s=time.perf_counter() - t0)
        if kind == "build":
            self.last_build = SimpleNamespace(
                iter=rec["iter"], spans=dict(getattr(res, "spans", {})),
                counts=dict(getattr(res, "counts", {})))
        return rec, answer

    def solver(self):
        """The live solver of the kept model (``resolve`` cells); ``None``
        in a ``build`` cell, whose models end with their requests."""
        return None if self.backend is None else self.backend.solver

    def release(self):
        """Drop the program's state and its device memory."""
        self.model = self.backend = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def read_answer(model, backend, res):
    """The answer through the public queries, as host numpy arrays."""
    from infiniteexamodels_jl_torch.modeling import All

    values = {}
    for v in list(model.finite_vars) + list(model.infinite_vars):
        values[v.name] = np.array(model.value(v, label=All), dtype=np.float64)
    derivs = {str(d): np.array(model.value(d, label=All), dtype=np.float64)
              for d in model.all_derivatives()}
    duals = [np.array(model.dual(c, label=All), dtype=np.float64)
             for c in model.constraints]
    bound_duals = {}
    for v in list(model.finite_vars) + list(model.infinite_vars):
        if v.info.lb is not None or v.info.ub is not None:
            zl, zu = backend.domain_duals(v)
            bound_duals[v.name] = (np.array(zl, dtype=np.float64),
                                   np.array(zu, dtype=np.float64))
    return {"status": res.status, "objective": float(res.objective),
            "values": values, "derivatives": derivs, "duals": duals,
            "bound_duals": bound_duals}


@contextlib.contextmanager
def recording_k1(launches):
    """Record ``(batch, n, bytes per element)`` of every K1 launch on the
    card by wrapping ``solvers.chol_linv.chol_linv`` in each module of the
    program that imported it."""
    from infiniteexamodels_jl_torch.solvers import chol_linv as k1

    orig = k1.chol_linv

    def wrapper(D):
        if D.device.type == "cuda" and D.shape[0] > 0:
            launches.append((int(D.shape[0]), int(D.shape[-1]),
                             D.element_size()))
        return orig(D)

    # every importer of the function, not its own module (whose global
    # name carries the launch counter)
    patched = [mod for name, mod in list(sys.modules.items())
               if name.split(".")[0] == PACKAGE and mod is not k1
               and getattr(mod, "chol_linv", None) is orig]
    for mod in patched:
        mod.chol_linv = wrapper
    try:
        yield launches
    finally:
        for mod in patched:
            mod.chol_linv = orig
