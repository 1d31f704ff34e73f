"""``ipm.self_step_ms``: self time of ``ipm.step``, its five phases and
``ipm.trial`` (the IPM's elementwise work and Python) per step of the
window's last request, in milliseconds."""
from portbench.program_spans import IPM_SELF, share_reader

read = share_reader(IPM_SELF)
