"""Host ms per window frame in the program's root span `eval step`
(monodetr_torch/train/train_step.py:make_eval_step): launching the eval
forward and the top-k."""

from bench_h100.core.spans import root_ms


def read(record, ring=None):
    return root_ms(record, "stream", "eval step", ring)
