"""Share of the window's steps whose root span `train step`
(monodetr_torch/train/train_step.py:make_train_step) replayed the training
step's CUDA graphs: the roots whose entry counts one `train_graph_replay`,
in %.  None for a program whose `train step` roots count neither a
capture nor a replay, as a program without the graphs."""

from bench_h100.core.spans import program_ring, window_roots

COUNTERS = ("train_graph_capture", "train_graph_replay")


def read(record, ring=None):
    ring = program_ring() if ring is None else ring
    if ring is None or not any(r.name == "train step" and any(c in r.counts for c in COUNTERS)
                               for r in ring):
        return None
    roots = window_roots(record, "train", "train step", ring)
    if roots is None:
        return None
    return 100.0 * sum(r.counts.get("train_graph_replay", 0) == 1 for r in roots) / len(roots)
