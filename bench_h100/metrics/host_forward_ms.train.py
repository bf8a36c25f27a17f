"""Host ms per window step in the program's `forward` span (the autocast
model call, the model's own spans inside it) under its `train step` root
(monodetr_torch/train/train_step.py), inclusive."""

from bench_h100.core.spans import child_ms


def read(record, ring=None):
    return child_ms(record, "train", "train step", "forward", ring)
