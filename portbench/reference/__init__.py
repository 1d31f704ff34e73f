"""The plain reference that decides ``correct``.

Each configuration names a module here (its ``"reference"`` key).  The
module re-derives the configuration's NLP from the published equations
and from the inputs the benchmark hands to both sides (supports, drawn
tracking references or scenarios, the frozen MATPOWER case), and judges
one answer of the program: ``residuals(inputs, answer)`` returns the
numbers that ``portbench.judge`` compares with the configuration's limits.

Plain NumPy, SciPy's banded solver and PyTorch autograd on the CPU in
float64; nothing here imports the program or JAX.
"""
