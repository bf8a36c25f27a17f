"""Host ms per window frame in the program's root span `decode`
(monodetr_torch/eval/decode.py:decode_detections): the detections to KITTI
rows on the host."""

from bench_h100.core.spans import root_ms


def read(record, ring=None):
    return root_ms(record, "stream", "decode", ring)
