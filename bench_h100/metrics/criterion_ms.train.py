"""Device ms per profiled training step of the kernels attributed to the
criterion and the matcher (models/criterion.py, models/matcher.py,
ops/lap.py), backward kernels to their forward range."""

from bench_h100.core.readers import component_ms


def read(record):
    return component_ms(record, "train", ("criterion", "matcher"))
