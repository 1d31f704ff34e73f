"""``device.idle_pct.build``: the share of the traced window in which no
kernel, copy or set ran on the card (one less the union of the device
intervals over the window), in percent."""
from portbench.metrics_common import idle_pct


def read(run):
    return idle_pct(run)
