from .backend import ExaTranscriptionBackend, NoOptimizerError  # noqa: F401
from ..transcribe import TranscriptionData  # noqa: F401
