"""Host ms per frame spent launching the forward and decoding; time blocked in
the copy to the host is left out."""

from bench_h100.core.readers import host_ms


def read(record):
    return host_ms(record, "stream")
