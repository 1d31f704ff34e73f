"""``ipm.host_sync_step_ms``: time in ``ipm.host_sync`` (the host's reads
of device values, each a wait for the card's queue there) per step of the
window's last request, in milliseconds."""
from portbench.program_spans import share_reader

read = share_reader("ipm.host_sync")
