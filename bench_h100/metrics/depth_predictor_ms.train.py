"""Device ms per profiled training step of the kernels attributed to the depth
predictor (models/depth_predictor.py), backward kernels to their forward
range."""

from bench_h100.core.readers import component_ms


def read(record):
    return component_ms(record, "train", ("depth predictor",))
