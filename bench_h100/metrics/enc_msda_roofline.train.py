"""The encoder MSDA range's least time (forward and backward, no
recomputation; bytes over 3.35 TB/s, bf16 products over 989.4 TFLOP/s, f32
sampling over 67 TFLOP/s, the largest) over its device time per step, in %."""

from bench_h100.core.readers import enc_msda_roofline


def read(record):
    return enc_msda_roofline(record, "train", ("fwd", "bwd"))
