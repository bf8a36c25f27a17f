"""Host ms per window frame in the program's root span `batch_to_device`
(monodetr_torch/train/train_step.py): pinning the frame and queueing its
copies to the card."""

from bench_h100.core.spans import root_ms


def read(record, ring=None):
    return root_ms(record, "stream", "batch_to_device", ring)
