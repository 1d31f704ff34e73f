"""``kkt.solve_step_ms``: self time of ``kkt.solve`` (the first solve, the
refinement rounds' solves and matvecs, the second-order correction's
solve; not their host syncs) per step of the window's last request, in
milliseconds."""
from portbench.program_spans import share_reader

read = share_reader("kkt.solve")
