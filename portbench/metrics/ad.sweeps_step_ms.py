"""``ad.sweeps_step_ms``: self time of every AD sweep (spans ``ad.*``)
per step of the window's last request, in milliseconds."""
from portbench.program_spans import AD_SWEEPS, share_reader

read = share_reader(AD_SWEEPS)
