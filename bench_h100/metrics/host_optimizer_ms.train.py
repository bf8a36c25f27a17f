"""Host ms per window step in the program's `optimizer` span under its
`train step` root (monodetr_torch/train/optimizer.py)."""

from bench_h100.core.spans import child_ms


def read(record, ring=None):
    return child_ms(record, "train", "train step", "optimizer", ring)
