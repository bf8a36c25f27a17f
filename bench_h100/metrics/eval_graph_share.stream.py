"""Share of the window's frames whose root span `eval step`
(monodetr_torch/train/train_step.py:make_eval_step) replayed the eval
step's CUDA graph: the roots whose entry counts one `eval_graph_replay`,
in %.  None for a program whose `eval step` roots count neither a capture
nor a replay, as a program without the graph."""

from bench_h100.core.spans import program_ring, window_roots

COUNTERS = ("eval_graph_capture", "eval_graph_replay")


def read(record, ring=None):
    ring = program_ring() if ring is None else ring
    if ring is None or not any(r.name == "eval step" and any(c in r.counts for c in COUNTERS)
                               for r in ring):
        return None
    roots = window_roots(record, "stream", "eval step", ring)
    if roots is None:
        return None
    return 100.0 * sum(r.counts.get("eval_graph_replay", 0) == 1 for r in roots) / len(roots)
