"""Training images completed in the window over its seconds."""

from bench_h100.core.readers import rate


def read(record):
    return rate(record, "train")
