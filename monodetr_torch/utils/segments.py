"""Segments: the stretches of work that a training step may replay as CUDA
graphs (train/train_step.py:StepGraphs).

    feats = segment("backbone", self.backbone[0], x)

runs fn(*args) inside span(name) (utils/trace.py; no span where name is
None) and returns what it returns.  While a training step routes its
segments (`routed(run)`, on the thread that runs the step), the call goes
to run(name, fn, args) instead, which captures the segment's work once and
replays it on later steps.  So a segment reads tensors only through its
arguments, the model's parameters and buffers, and constant tables
(ops/utils.py:device_constant), and returns its results: a replay reads
anything else it touched at the address that thing had at the capture,
and no Python of the segment runs.  The model's forward is cut into
segments at its spans (models/monodetr.py, models/transformer.py), and the
optimizer's update is one (train/optimizer.py).
"""

import contextlib
import threading

from .trace import span

_local = threading.local()  # .run: the thread's routed runner, or None


def segment(name, fn, *args):
    """fn(*args) inside span(name), or what the routed runner makes of it."""
    run = getattr(_local, "run", None)
    if run is not None:
        return run(name, fn, args)
    if name is None:
        return fn(*args)
    with span(name):
        return fn(*args)


@contextlib.contextmanager
def routed(run):
    """While open, segment() on this thread calls run(name, fn, args)
    (run None: segments run as written)."""
    outer = getattr(_local, "run", None)
    _local.run = run
    try:
        yield
    finally:
        _local.run = outer
