from .timers import PhaseTimers  # noqa: F401
