"""``kkt.assemble_self_step_ms``: self time of ``kkt.assemble`` (the KKT
assembly without its Hessian sweep) per step of the window's last
request, in milliseconds."""
from portbench.program_spans import share_reader

read = share_reader("kkt.assemble_self")
