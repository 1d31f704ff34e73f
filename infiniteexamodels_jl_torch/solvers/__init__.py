from .ipm import IpmSolver, MadIpmSolver  # noqa: F401
from .kkt import DenseKKT  # noqa: F401
from .results import (  # noqa: F401
    ExecutionStats, TerminationStatus, ResultStatus,
    translate_termination_status, translate_result_status,
)
