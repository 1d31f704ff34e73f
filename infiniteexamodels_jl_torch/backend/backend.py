"""ExaTranscriptionBackend: the transformation-backend lifecycle layer.

Python re-design of the reference's L4
(InfiniteExaModels.jl/src/infiniteopt_backend.jl): build/empty/ready tracking,
the two-level options system (user `options` vs `prev_options` seen by the
live solver, with delta-only resends and reversible silent/time-limit
overlays, semantics pinned by the reference's
ext/InfiniteExaModelsIpopt.jl:10-39 and test/ipopt.jl+test/madnlp.jl),
cold solve vs warm resolve, warm starts, and value/dual/support queries
with public/internal label filtering.
"""
from __future__ import annotations

import time
import warnings

import numpy as np

from ..solvers import (IpmSolver, translate_termination_status,
                       translate_result_status, TerminationStatus,
                       ResultStatus)
from ..transcribe import transcribe, TranscriptionData  # noqa: F401
from ..utils.device import resolve_device
from ..utils.timers import span, spanned
from ..modeling.refs import (
    InfiniteParameter, FiniteParameter, FiniteVar, InfiniteVar,
    DerivativeRef, SemiInfiniteVar, PointVar, ParameterFunctionRef,
    label_matches, All, PublicLabel,
)

DEFAULT_PRINT_LEVEL = 5
SILENT_PRINT_LEVEL = 0
DEFAULT_WALL_TIME = 1.0e20


class NoOptimizerError(RuntimeError):
    pass


class ExaTranscriptionBackend:
    """Create with a solver type (class with (model, **opts) ctor and
    solve()/reset()), e.g. ``ExaTranscriptionBackend(IpmSolver)``;
    ``device=`` selects the torch device, the analogue of the reference's
    ``backend = CUDABackend()`` (infiniteopt_backend.jl:97-131).  The
    default is the CUDA card; on a host without one this raises instead of
    running on the CPU (pass ``device="cpu"`` for that).

    ``mesh=`` (a :class:`~..parallel.Mesh`) spreads the model over the
    ranks of a process group: family rows are padded to the mesh size and
    each rank keeps its share at build, and the structured KKT then
    assembles and factors each rank's scenario or time blocks on its own
    device (``device`` defaults to the mesh's)."""

    def __init__(self, solver_type=None, device=None, mesh=None,
                 **solver_options):
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh
        self.core = None           # ops.Core (host-side mutable data)
        self.model = None          # ops.SimdModel
        self.data = TranscriptionData()
        self.solver = None
        self.options = {}
        self.prev_options = {}
        self.silent = False
        self.time_limit = np.nan
        self.results = None
        self.solve_time = np.nan
        self.ready = False
        self._inf_model = None
        if solver_type is not None:
            self.set_optimizer(solver_type, **solver_options)

    # -- lifecycle -------------------------------------------------------
    def attach(self, inf_model):
        self._inf_model = inf_model
        self.ready = False

    def empty(self):
        """Drop transcription + solver state, keep user options (reference
        Base.empty!, infiniteopt_backend.jl:134-143)."""
        self.core = None
        self.model = None
        self.prev_options = {}
        self.solver = None
        self.results = None
        self.solve_time = np.nan
        self.data = TranscriptionData()
        return self

    @spanned("backend.build")
    def build(self, inf_model=None):
        inf_model = inf_model or self._inf_model
        self.empty()
        t0 = time.time()
        row_pad = self.mesh.size if self.mesh is not None else 1
        self.model, self.data = transcribe(inf_model, device=self.device,
                                           row_pad=row_pad)
        if self.mesh is not None:
            from ..parallel import shard_model

            shard_model(self.model, self.mesh)
        self.core = self.model.core
        self.build_time = time.time() - t0
        self.ready = True

    # -- options (reference infiniteopt_backend.jl:159-252) ---------------
    def set_attribute(self, name, value):
        self.solve_time = np.nan
        self.options[str(name)] = value

    def get_attribute(self, name):
        if str(name) not in self.options:
            raise KeyError(f"attribute {name!r} not found")
        return self.options[str(name)]

    def set_optimizer(self, solver_type, **params):
        self.options = {}
        self.set_attribute("solver", solver_type)
        self.solver = None
        for k, v in params.items():
            self.set_attribute(k, v)

    def solver_name(self):
        s = self.options.get("solver")
        return s.__name__ if s is not None else "No solver attached"

    def _process_options(self, options):
        """Delta-only option resends with reversible silent/time-limit
        overlays (exact semantics of the reference ext glue
        _process_options)."""
        prev = self.prev_options
        new = {k: v for k, v in options.items()
               if k not in prev or prev[k] != v}
        if self.silent and prev.get("print_level",
                                    DEFAULT_PRINT_LEVEL) != SILENT_PRINT_LEVEL:
            new["print_level"] = SILENT_PRINT_LEVEL
        elif (not self.silent
              and prev.get("print_level",
                           DEFAULT_PRINT_LEVEL) == SILENT_PRINT_LEVEL
              and "print_level" not in options):
            new["print_level"] = DEFAULT_PRINT_LEVEL
        if not np.isnan(self.time_limit) and \
                prev.get("max_wall_time", np.nan) != self.time_limit:
            new["max_wall_time"] = self.time_limit
        elif ("max_wall_time" not in options and np.isnan(self.time_limit)
              and prev.get("max_wall_time",
                           DEFAULT_WALL_TIME) != DEFAULT_WALL_TIME):
            new["max_wall_time"] = DEFAULT_WALL_TIME
        prev.update(new)
        return new

    # -- solve (reference JuMP.optimize!, infiniteopt_backend.jl:259-271) --
    @spanned("backend.optimize")
    def optimize(self, inf_model=None):
        inf_model = inf_model or self._inf_model
        if not self.ready:
            self.build(inf_model)
        if "solver" not in self.options:
            raise NoOptimizerError("no solver attached; call set_optimizer")
        solver_type = self.options["solver"]
        options = {k: v for k, v in self.options.items() if k != "solver"}
        t0 = time.time()
        # push host-side core mutations (start values, theta) to the device
        with span("backend.refresh"):
            self.model.refresh_from_core()
        if self.solver is None:
            sol_options = self._process_options(options)
            with span("ipm.setup"):
                self.solver = solver_type(self.model, **sol_options)
            self.results = self.solver.solve()
        else:
            sol_options = self._process_options(options)
            with span("ipm.setup"):
                self.solver.reset(self.model)
            self.results = self.solver.solve(**sol_options)
        self.solve_time = time.time() - t0
        return self.results

    # -- status / result queries -----------------------------------------
    def _check_results(self):
        if self.results is None:
            raise RuntimeError("no solution available to query")

    def result_count(self):
        return 0 if self.results is None else 1

    def raw_status(self):
        if self.results is None:
            return "optimize not called"
        return str(self.results.status)

    def termination_status(self):
        if self.results is None:
            return TerminationStatus.OPTIMIZE_NOT_CALLED
        return translate_termination_status(self.results.status)

    def primal_status(self):
        if self.results is None:
            return ResultStatus.NO_SOLUTION
        return translate_result_status(self.results.status)

    dual_status = primal_status

    def solve_time_sec(self):
        self._check_results()
        return self.solve_time

    def objective_value(self):
        self._check_results()
        return self.results.objective

    # -- label filtering (reference _label_filter,
    #    infiniteopt_backend.jl:303-314) ----------------------------------
    def _axis_masks(self, groups, label):
        masks = []
        for g in groups:
            labels = self.data.support_labels[g.gid]
            masks.append(np.array(
                [label_matches(label, s) for s in labels]))
        return masks

    def _label_filter(self, arr, groups, label):
        if label is All or not groups:
            return arr
        if not any(self.data.has_internal[g.gid] for g in groups) \
                and label is PublicLabel:
            return arr
        masks = self._axis_masks(groups, label)
        return arr[np.ix_(*masks)]

    # -- value queries (reference map_value,
    #    infiniteopt_backend.jl:448-481) -----------------------------------
    def map_value(self, ref, label=PublicLabel):
        d = self.data
        if isinstance(ref, FiniteParameter):
            par = d._get(d.param_map, ref)
            if par is None:
                return ref.value
            return float(np.asarray(self.model.theta_view(par)).reshape(-1)[0])
        if isinstance(ref, ParameterFunctionRef):
            par = d._get(d.param_map, ref)
            return np.asarray(self.model.theta_view(par))
        if isinstance(ref, InfiniteParameter):
            g = ref.group
            supps = g.supports() if g.scalar else g.supports()[:, ref.index]
            mask = self._axis_masks([g], label)[0]
            return supps[mask] if label is not All else supps
        self._check_results()
        sol = self.results.solution
        if isinstance(ref, FiniteVar):
            return float(sol[d._get(d.finvar_map, ref).i])
        if isinstance(ref, PointVar):
            entry = d._get(d.finvar_map, ref)
            if entry is None:
                raise KeyError(f"no mapping found for {ref!r}")
            return float(sol[entry.i])
        if isinstance(ref, (InfiniteVar, DerivativeRef)):
            var = d._get(d.infvar_map, ref)
            vals = self.model.solution(sol, var)
            return self._label_filter(np.asarray(vals), ref.groups, label)
        if isinstance(ref, SemiInfiniteVar):
            got = d._get(d.semivar_info, ref)
            if got is None:
                raise KeyError(f"no mapping found for {ref!r}")
            mapped, indexing = got
            if hasattr(mapped, "vid"):
                vals = self.model.solution(sol, mapped)
            else:
                vals = np.asarray(self.model.theta_view(mapped))
            sel = tuple(ix if isinstance(ix, int) else slice(None)
                        for ix in indexing)
            return self._label_filter(np.asarray(vals)[sel], ref.groups,
                                      label)
        raise TypeError(f"cannot query value of {ref!r}")

    # -- dual queries (reference map_dual,
    #    infiniteopt_backend.jl:485-508) ------------------------------------
    def map_dual(self, cref, label=PublicLabel):
        self._check_results()
        fam = self.data.lookup_constraint(cref)
        duals = -np.asarray(self.model.multipliers(
            self.results.multipliers, fam))
        if cref.restriction is not None:
            return duals           # restricted: flat over surviving rows
        dims = tuple(g.num_supports() for g in cref.groups)
        if dims:
            duals = duals.reshape(dims)
        else:
            return float(duals[0])
        return self._label_filter(duals, cref.groups, label)

    def domain_duals(self, var):
        """Bound duals of a decision variable (the reference's
        variable-domain-constraint duals via multipliers_L/U,
        infiniteopt_backend.jl:485-503)."""
        self._check_results()
        d = self.data
        if isinstance(var, FiniteVar):
            i = d._get(d.finvar_map, var).i
            return (self.results.multipliers_L[i],
                    self.results.multipliers_U[i])
        v = d._get(d.infvar_map, var)
        sl = slice(v.offset, v.offset + v.length)
        shape = v.shape
        return (self.results.multipliers_L[sl].reshape(shape),
                self.results.multipliers_U[sl].reshape(shape))

    # -- supports queries (reference variable_supports,
    #    infiniteopt_backend.jl:288-348) -----------------------------------
    def ref_supports(self, ref, label=PublicLabel):
        if isinstance(ref, InfiniteParameter):
            return self.map_value(ref, label=label)
        groups = getattr(ref, "groups", ())
        if not groups:
            return ()
        if len(groups) == 1 and groups[0].scalar:
            g = groups[0]
            mask = self._axis_masks([g], label)[0] if label is not All \
                else np.ones(g.num_supports(), bool)
            return g.supports()[mask]
        # multi-group: object grid of support tuples
        masks = self._axis_masks(groups, label) if label is not All else \
            [np.ones(g.num_supports(), bool) for g in groups]
        grids = [g.supports()[m] for g, m in zip(groups, masks)]
        dims = tuple(len(gr) for gr in grids)
        out = np.empty(dims, dtype=object)
        for idx in np.ndindex(*dims):
            out[idx] = tuple(
                float(gr[i]) if gr.ndim == 1 else tuple(gr[i])
                for gr, i in zip(grids, idx))
        return out

    # -- in-place updates (reference infiniteopt_backend.jl:511-592) -------
    def update_parameter_value(self, ref, value):
        d = self.data
        par = d._get(d.param_map, ref)
        if par is None:
            return False
        if isinstance(ref, FiniteParameter):
            self.model.set_parameter(par, [float(value)])
        else:  # parameter function: re-evaluate over the support grid
            dims = tuple(g.num_supports() for g in ref.groups)
            grids = [g.supports() for g in ref.groups]
            vals = np.empty(dims)
            for idx in np.ndindex(*dims):
                args = [grid[i] for grid, i in zip(grids, idx)]
                vals[idx] = value(*args)
            self.core.set_parameter(par, vals.reshape(-1))
            self.model.set_parameter(par, vals.reshape(-1))
        return True

    def update_start_value(self, ref, value):
        d = self.data
        if isinstance(ref, (InfiniteVar, DerivativeRef)):
            var = d._get(d.infvar_map, ref)
            if var is None:
                return False
            if callable(value):
                dims = tuple(g.num_supports() for g in ref.groups)
                grids = [g.supports() for g in ref.groups]
                vals = np.empty(dims)
                for idx in np.ndindex(*dims):
                    args = [grid[i] for grid, i in zip(grids, idx)]
                    vals[idx] = value(*args)
                self.core.set_start(var, vals.reshape(-1))
            else:
                self.core.set_start(var, float(value))
            return True
        if isinstance(ref, (FiniteVar, PointVar)):
            entry = d._get(d.finvar_map, ref)
            if entry is None:
                return False
            self.core.set_bounds_entry(entry, start=float(value))
            return True
        return False

    # -- warm start (reference warmstart_backend,
    #    infiniteopt_backend.jl:595-615) ------------------------------------
    def warmstart(self):
        if self.results is None:
            warnings.warn("No previous solution values found. Unable to "
                          "warmstart backend.")
            return
        self.core.set_x0_flat(np.asarray(self.results.solution))
        self.model.set_y0(np.asarray(self.results.multipliers))
