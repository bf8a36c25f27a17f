"""Device ms per profiled training step of the kernels attributed to the
decoder (models/transformer.py) with its three inner ranges, backward
kernels to their forward range."""

from bench_h100.core.readers import component_ms


def read(record):
    return component_ms(record, "train", ("decoder", "decoder self-attention",
                                           "decoder MSDA", "decoder depth cross-attention"))
