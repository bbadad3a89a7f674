"""idle_pct.train (device): share (%) of the traced slice in which no device
operation ran: one minus the union of the device intervals over the slice."""

from hov_bench.core.readers import idle_pct


def read(run):
    return idle_pct(run)
