"""Host ms per window step in the program's `backward` span under its
`train step` root: the host waits there while the autograd engine's thread
launches the backward's kernels."""

from bench_h100.core.spans import child_ms


def read(record, ring=None):
    return child_ms(record, "train", "train step", "backward", ring)
