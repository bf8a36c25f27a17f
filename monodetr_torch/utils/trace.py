"""The program's spans and counters: where its host time goes, and how many
of its kernels it launched.

    with span("forward"):       # a named stretch of host work
        ...
    count("lap")                # one launch of a port kernel (or one event
                                # of the eval step's CUDA graph)

A span is always on.  It takes the host clock (`time.perf_counter_ns`) at
entry and at exit and keeps a stack per thread, so each span knows its
parent and its own (self) time: its duration less that of its children.
A span closes on the thread that opened it, inner spans first (no `yield`
inside one).  A span opened with no span open on its thread is a root:
the training step, the serving path's host-to-device copy, eval step and
decode, the wait for the next prefetched batch.  Spans opened on another thread (the
prefetcher's, the autograd engine's) are roots of that thread.  When a
root closes, one `Root` entry goes into a ring of the last RING_ENTRIES
roots of the process (more than 51 s of roots at one a millisecond): its
name, start and end, its self time, the inclusive time of each named
descendant (summed over the spans of that name), and the port kernels
counted while it was open, on any thread (the backward's kernels launch
on the autograd engine's thread).  A replay of a step's CUDA graphs
runs none of the model's Python: an `eval step` root then holds no inner
span and no kernel counts, only `eval_graph_replay`, and a `train step`
root no span inside a segment and no kernel counts but the criterion's
(train/train_step.py:StepGraphs).
`roots()` reads the ring; `counts()` reads the process's totals.

While a torch.profiler records, a span also opens a profiler range named
COMPONENT_PREFIX + name, so every span sits on the profiler's timeline
beside the device's kernels (profile_train.py --by-component and the
benchmark's trace reduction attribute kernels to the innermost range).
The host-clock part costs 1-2 us a span and 2-3 us a root on the H100
machine's host.
"""

import collections
import threading
import time

import torch

COMPONENT_PREFIX = "component::"
# 65.5 s of roots at one a millisecond
RING_ENTRIES = 1 << 16

Root = collections.namedtuple(
    "Root", "name start_ns end_ns self_ns spans counts", module=__name__)
Root.__doc__ = """One closed root span.  start_ns and end_ns are on the host
clock (time.perf_counter_ns); self_ns is the time no child span covered;
spans maps each descendant's name to its inclusive ns, counts maps each
counter to what was counted while the root was open."""

_ring = collections.deque(maxlen=RING_ENTRIES)
_totals = {}
_totals_lock = threading.Lock()
_local = threading.local()  # .stack: the thread's open spans, outermost first
_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled
_new_tuple = tuple.__new__


class span:
    """`with span(name):` records the block as a span named `name` (see
    the module's docstring)."""

    __slots__ = ("name", "stack")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        # a frame: [name, children's ns, profiler range, start] and, for a
        # root, [descendants' inclusive ns by name, counts at entry]
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.stack = stack
        rng = None
        if _profiling():
            rng = torch.profiler.record_function(COMPONENT_PREFIX + self.name)
            rng.__enter__()
        if stack:
            stack.append([self.name, 0, rng, _clock()])
        else:
            stack.append([self.name, 0, rng, _clock(), {}, _totals.copy()])
        return self

    def __exit__(self, exc_type, exc, tb):
        end = _clock()
        stack = self.stack
        frame = stack.pop()
        took = end - frame[3]
        if frame[2] is not None:
            frame[2].__exit__(exc_type, exc, tb)
        if stack:
            stack[-1][1] += took
            spans = stack[0][4]
            spans[self.name] = spans.get(self.name, 0) + took
        else:
            base = frame[5]
            counted = {} if _totals == base else {
                k: v - base.get(k, 0) for k, v in _totals.copy().items() if v != base.get(k, 0)}
            # tuple.__new__: Root's own __new__ is Python, three times the cost
            _ring.append(_new_tuple(Root, (self.name, frame[3], end, took - frame[1], frame[4],
                                           counted)))
        return False


def count(name, n=1):
    """Adds n to the counter `name`: a port kernel's launches (the name is
    the kernel's, as chip_smoke.py:KERNELS has it), and the steps' CUDA
    graph captures and replays (`eval_graph_capture`, `eval_graph_replay`,
    `train_graph_capture`, `train_graph_replay`,
    train/train_step.py:StepGraphs), and the proposal variants' tokens
    scored and picks taken (`proposal_tokens`, `proposal_picks`,
    models/transformer.py).  A kernel launched by a graph's replay is not
    counted: only its capture is."""
    with _totals_lock:
        _totals[name] = _totals.get(name, 0) + n


def counts():
    """{counter: total since the process started}, a copy."""
    with _totals_lock:
        return dict(_totals)


def roots():
    """The ring's entries (Root), oldest first, a copy."""
    return list(_ring)


def last(name, n):
    """The last n roots named `name` still in the ring, oldest first
    (fewer where the ring holds fewer)."""
    out = []
    for root in reversed(roots()):  # a copy: other threads append meanwhile
        if len(out) == n:
            break
        if root.name == name:
            out.append(root)
    return out[::-1]
