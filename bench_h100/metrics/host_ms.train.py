"""Host ms per training step spent inside the step call, which returns before
the card finishes, over the window's steps."""

from bench_h100.core.readers import host_ms


def read(record):
    return host_ms(record, "train")
