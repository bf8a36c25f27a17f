"""Frozen training operations per image (no recomputation) x the window's
img/s over the bf16 peak, in %."""

from bench_h100.core.readers import mfu


def read(record):
    return mfu(record, "train", "train_flops_per_img")
