"""Solver execution stats and status translation tables.

Mirrors the SolverCore.AbstractExecutionStats surface consumed by the
reference backend (InfiniteExaModels.jl/src/infiniteopt_backend.jl:106,408,444,
600-601) and its JSO-status -> MOI translation tables (:360-391).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

import numpy as np


class TerminationStatus(Enum):
    """MOI.TerminationStatusCode analogue."""
    OPTIMIZE_NOT_CALLED = "OPTIMIZE_NOT_CALLED"
    LOCALLY_SOLVED = "LOCALLY_SOLVED"
    ALMOST_LOCALLY_SOLVED = "ALMOST_LOCALLY_SOLVED"
    SLOW_PROGRESS = "SLOW_PROGRESS"
    INFEASIBLE_OR_UNBOUNDED = "INFEASIBLE_OR_UNBOUNDED"
    ITERATION_LIMIT = "ITERATION_LIMIT"
    TIME_LIMIT = "TIME_LIMIT"
    INTERRUPTED = "INTERRUPTED"
    OTHER_ERROR = "OTHER_ERROR"
    OTHER_LIMIT = "OTHER_LIMIT"
    NUMERICAL_ERROR = "NUMERICAL_ERROR"
    INVALID_MODEL = "INVALID_MODEL"


class ResultStatus(Enum):
    """MOI.ResultStatusCode analogue."""
    NO_SOLUTION = "NO_SOLUTION"
    FEASIBLE_POINT = "FEASIBLE_POINT"
    NEARLY_FEASIBLE_POINT = "NEARLY_FEASIBLE_POINT"
    INFEASIBLE_POINT = "INFEASIBLE_POINT"
    UNKNOWN_RESULT_STATUS = "UNKNOWN_RESULT_STATUS"


# JSO-style status symbols -> MOI termination codes
# (parity with InfiniteExaModels.jl/src/infiniteopt_backend.jl:360-374)
TERMINATION_MAP = {
    "first_order": TerminationStatus.LOCALLY_SOLVED,
    "acceptable": TerminationStatus.ALMOST_LOCALLY_SOLVED,
    "small_step": TerminationStatus.SLOW_PROGRESS,
    "infeasible": TerminationStatus.INFEASIBLE_OR_UNBOUNDED,
    "unbounded": TerminationStatus.INFEASIBLE_OR_UNBOUNDED,
    "max_iter": TerminationStatus.ITERATION_LIMIT,
    "max_time": TerminationStatus.TIME_LIMIT,
    "user": TerminationStatus.INTERRUPTED,
    "exception": TerminationStatus.OTHER_ERROR,
    "stalled": TerminationStatus.OTHER_ERROR,
    "max_eval": TerminationStatus.OTHER_LIMIT,
    "neg_pred": TerminationStatus.OTHER_ERROR,
    "not_desc": TerminationStatus.OTHER_ERROR,
    "restoration_failed": TerminationStatus.NUMERICAL_ERROR,
    "invalid_number": TerminationStatus.INVALID_MODEL,
}

# (parity with infiniteopt_backend.jl:377-381)
RESULT_MAP = {
    "first_order": ResultStatus.FEASIBLE_POINT,
    "acceptable": ResultStatus.NEARLY_FEASIBLE_POINT,
    "infeasible": ResultStatus.INFEASIBLE_POINT,
}


def translate_termination_status(status: str) -> TerminationStatus:
    return TERMINATION_MAP.get(status, TerminationStatus.OTHER_ERROR)


def translate_result_status(status: str) -> ResultStatus:
    return RESULT_MAP.get(status, ResultStatus.UNKNOWN_RESULT_STATUS)


@dataclass
class ExecutionStats:
    """Solve results (SolverCore.AbstractExecutionStats analogue)."""
    status: str = "unknown"
    objective: float = np.nan
    solution: np.ndarray = field(default_factory=lambda: np.zeros(0))
    multipliers: np.ndarray = field(default_factory=lambda: np.zeros(0))
    multipliers_L: np.ndarray = field(default_factory=lambda: np.zeros(0))
    multipliers_U: np.ndarray = field(default_factory=lambda: np.zeros(0))
    iter: int = 0
    solve_time: float = np.nan
    primal_feas: float = np.nan
    dual_feas: float = np.nan
    # structured per-phase timers (SURVEY.md §5: replaces the reference's
    # solver-log text parsing with first-class metrics)
    timers: dict = field(default_factory=dict)
