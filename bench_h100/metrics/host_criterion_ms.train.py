"""Host ms per window step in the program's `criterion` span under its
`train step` root, inclusive: the losses, the matcher and the LAP kernel's
launch (monodetr_torch/models/criterion.py, models/matcher.py, ops/lap.py)."""

from bench_h100.core.spans import child_ms


def read(record, ring=None):
    return child_ms(record, "train", "train step", "criterion", ring)
