"""Device ms per profiled training step of the kernels attributed to the
segment that makes the decoder's first queries (`queries`,
models/transformer.py): under `two_stage_dino` the proposal heads over
every encoder token, the top-k and the gather, backward kernels to their
forward range.  None where no `train step` root of the window counts
`proposal_picks`: a model without proposals, or a program without the
counter."""

from bench_h100.core.readers import component_ms
from bench_h100.core.spans import window_roots


def read(record, ring=None):
    roots = window_roots(record, "train", "train step", ring)
    if roots is None or not any(r.counts.get("proposal_picks") for r in roots):
        return None
    return component_ms(record, "train", ("queries",))
