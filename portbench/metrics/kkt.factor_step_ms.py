"""``kkt.factor_step_ms``: self time of ``kkt.factor`` and its K1 launches
(``k1.chol_linv``) per step of the window's last request, in
milliseconds; every regularization try factors once."""
from portbench.program_spans import share_reader

read = share_reader("kkt.factor")
