from .data import TranscriptionData  # noqa: F401
from .transcriber import transcribe, OBJ_MEASURE_WARN, CON_MEASURE_WARN  # noqa: F401
