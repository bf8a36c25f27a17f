"""Device ms per profiled training step of the kernels attributed to the
optimizer (train/optimizer.py), backward kernels to their forward range."""

from bench_h100.core.readers import component_ms


def read(record):
    return component_ms(record, "train", ("optimizer",))
