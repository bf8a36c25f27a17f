"""1 - device-busy time per profiled step (union of kernel and copy intervals)
/ wall time per step of the window, in %."""

from bench_h100.core.readers import idle_pct


def read(record):
    return idle_pct(record, "stream")
