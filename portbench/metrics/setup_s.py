"""``setup_s``: process start to the first timed request (imports, CUDA
initialisation, K1 loaded or built, the model built and transcribed, the
solver built, one warm-up request of the cell's own shape)."""


def read(run):
    return run.setup_s
