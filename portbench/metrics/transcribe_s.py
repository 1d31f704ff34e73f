"""``transcribe_s``: the benchmark's span around the model function and
``backend.build`` (DSL and transcription), averaged over the window's
requests."""
from portbench.harness import mean


def read(run):
    return mean([r.get("transcribe_s") for r in run.untraced])
