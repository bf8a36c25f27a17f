"""monodetr_torch/utils/trace.py (the program's spans and counters) and the
benchmark's readers of its spans (bench_h100/core/spans.py and the seven
metrics/host_*_ms.*.py), on the CPU.

- A root's entry holds its descendants' inclusive times by name and its
  self time (its duration less its children's).
- A span on a second thread is a root of that thread; a root's counts are
  what every thread counted while it was open; counters lose no update
  under a short switch interval.
- The ring keeps the last RING_ENTRIES roots; a reader whose window has
  fallen out of it gives None.
- Under a CPU torch.profiler every span opens its `component::` range, and
  a root's ring start is the range's start after one constant offset.
- Each reader on a synthetic ring and record: the window's roots only,
  not the set-up's nor the profiled stretch's; None in another kind of
  cell and for a ring without the span.
- The tiny model's training step: forward, criterion, backward and
  optimizer plus the root's self time make the root; the trainer's line
  reads them and the waits for data from the ring.  Its eval step, decode
  and batch_to_device through the stream readers.
- The steps' CUDA graphs (train/train_step.py:StepGraphs): on the CPU
  neither step captures; the key of both changes with what a capture
  records (shapes, dtypes, plain_ops, CUDA autocast, TF32, the
  generator) and the address state with a moved or replaced tensor;
  `eval_graph_share.stream` reads the window's share of replays, None
  for a program whose roots count no capture or replay; device_constant
  inside held_constants takes and keeps its tables (the graphs' own
  behaviour is tests/test_torch_cuda.py's).
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from monodetr_torch.utils import trace
from monodetr_torch.utils.trace import Root, count, span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bench_h100.core import spec  # noqa: E402

BENCH = os.path.join(REPO, "bench_h100")
torch.set_num_threads(2)
MS = 1_000_000  # ns


def read(metric, record, ring=None):
    return spec.reader(metric, BENCH)(record, ring)


def test_nesting_and_self_time():
    with span("nest root"):
        time.sleep(0.002)
        with span("a"):
            with span("c"):
                time.sleep(0.002)
            time.sleep(0.001)
        with span("b"):
            time.sleep(0.001)
    root, = trace.last("nest root", 1)
    took = root.end_ns - root.start_ns
    assert set(root.spans) == {"a", "b", "c"}
    assert 2 * MS <= root.spans["c"] < root.spans["a"] - MS and root.spans["b"] >= MS
    assert root.self_ns == took - root.spans["a"] - root.spans["b"] >= 2 * MS
    assert root.counts == {}
    with span("twice"):  # two spans of one name: their times add
        for _ in range(2):
            with span("c"):
                time.sleep(0.001)
    root, = trace.last("twice", 1)
    assert set(root.spans) == {"c"} and root.spans["c"] >= 2 * MS
    assert root.self_ns == root.end_ns - root.start_ns - root.spans["c"]


def test_a_second_thread_has_roots_of_its_own_and_counts_go_to_open_roots():
    inside = threading.Event()

    def work():
        with span("worker root"):
            with span("worker child"):
                count("trace test kernel", 3)
        inside.set()

    with span("main root"):
        with span("main child"):
            t = threading.Thread(target=work)
            t.start()
            assert inside.wait(30)
            t.join(30)
    assert not t.is_alive()
    main, = trace.last("main root", 1)
    worker, = trace.last("worker root", 1)
    assert set(main.spans) == {"main child"} and set(worker.spans) == {"worker child"}
    assert main.counts == worker.counts == {"trace test kernel": 3}
    assert main.start_ns <= worker.start_ns <= worker.end_ns <= main.end_ns


def test_counters_lose_no_update_across_threads():
    before = trace.counts().get("trace stress", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count("trace stress") for _ in range(2000)])
                   for _ in range(3 * (os.cpu_count() or 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert trace.counts()["trace stress"] - before == 2000 * len(threads)


def test_the_ring_is_bounded_and_a_window_out_of_it_reads_none():
    for _ in range(5):
        with span("decode"):
            pass
    for _ in range(trace.RING_ENTRIES - 2):
        with span("ring filler"):
            pass
    ring = trace.roots()
    assert len(ring) == trace.RING_ENTRIES
    assert [r.name for r in ring[:2]] == ["decode", "decode"]  # 3 of 5 fell out
    assert len(trace.last("ring filler", trace.RING_ENTRIES)) == trace.RING_ENTRIES - 2
    record = {"kind": "stream", "window": {"steps": 2}}
    assert read("host_decode_ms.stream", record) >= 0
    record["window"]["steps"] = 3
    assert read("host_decode_ms.stream", record) is None


def _profiled_offsets(n):
    """(range names, ring start - range start in us of n roots, and the
    host clock in us just before the profile and just after it started)
    of one CPU profile."""
    before = time.perf_counter_ns() / 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        after = time.perf_counter_ns() / 1e3
        # the first range of a profile pays the profiler's set-up after its start
        with span("profiled first"):
            pass
        for i in range(n):
            with span(f"profiled {i}"):
                with span("profiled child"):
                    torch.ones(4).sum()
            time.sleep(0.002)
    events = [e for e in prof.events() if e.name.startswith(trace.COMPONENT_PREFIX)]
    names = [e.name[len(trace.COMPONENT_PREFIX):] for e in events]
    starts = dict(zip(names, (e.time_range.start for e in events)))
    return names, [r.start_ns / 1e3 - starts[r.name] for i in range(n)
                   for r in trace.last(f"profiled {i}", 1)], before, after


def test_spans_open_their_profiler_range_on_the_host_clock():
    """A root's ring start is its range's start (microseconds since the
    profile's start) plus one offset, the profile's start on the host
    clock.  A busy host can preempt a thread between a range's start and
    the clock's read, and the profiler's clock steps by tens of us, so
    the statistics are medians over 15 roots, which a few such roots
    cannot move: the offsets' median deviation from their median is under
    50 us (a span clock of another rate drifts apart over the roots'
    ~40 ms), and their median lies between the host clock's reads just
    before and just after the profile started, within 50 us (a clock of
    another epoch or rate misses it)."""
    names, offsets, before, after = _profiled_offsets(15)
    assert sorted(names) == sorted(["profiled first"] + [f"profiled {i}" for i in range(15)]
                                   + ["profiled child"] * 15)
    assert len(offsets) == 15
    mid = float(np.median(offsets))
    assert float(np.median(np.abs(np.array(offsets) - mid))) < 50.0, offsets
    assert before - 50.0 <= mid <= after + 50.0, (before, mid, after)


def _root(name, ms, **spans):
    return Root(name, 0, int(ms * MS), 0, {k: int(v * MS) for k, v in spans.items()}, {})


def _train_ring():
    """2 set-up steps, 3 window steps, 2 profiled steps, and roots of other
    names between them."""
    ring = []
    for i, scale in enumerate([100] * 2 + [1, 2, 3] + [500] * 2):
        ring.append(_root("data wait", 7))
        ring.append(_root("train step", 10 * scale, forward=4 * scale, criterion=scale,
                          backward=3 * scale, optimizer=scale / 2, matcher=scale / 4))
    return ring


def _stream_ring():
    ring = []
    for scale in [100] * 3 + [1, 2, 3] + [500] * 2:
        ring += [_root("batch_to_device", scale / 10), _root("eval step", 8 * scale),
                 _root("decode", 2 * scale)]
    return ring


TRAIN_RECORD = {"kind": "train", "window": {"steps": 3}, "trace": {"steps": 2}}
STREAM_RECORD = {"kind": "stream", "window": {"steps": 3}, "trace": {"steps": 2}}


@pytest.mark.parametrize("metric,want", [
    ("host_forward_ms.train", 8.0), ("host_criterion_ms.train", 2.0),
    ("host_backward_ms.train", 6.0), ("host_optimizer_ms.train", 1.0),
    ("host_h2d_ms.stream", 0.2), ("host_forward_ms.stream", 16.0),
    ("host_decode_ms.stream", 4.0),
])
def test_readers_take_the_window_and_leave_set_up_and_profiled_steps_out(metric, want):
    train = metric.endswith(".train")
    ring = _train_ring() if train else _stream_ring()
    record, other = (TRAIN_RECORD, STREAM_RECORD) if train else (STREAM_RECORD, TRAIN_RECORD)
    assert read(metric, record, ring) == pytest.approx(want)
    assert read(metric, other, _train_ring() + _stream_ring()) is None
    # the window's first entry no longer in the ring
    assert read(metric, record, ring[len(ring) // 2:]) is None
    # without a trace, the window is the last steps
    untraced = {"kind": record["kind"], "window": record["window"]}
    assert read(metric, untraced, ring[:-4 if train else -6]) == pytest.approx(want)
    # a program whose roots hold no such span
    bare = [r._replace(spans={}) if train else r._replace(name="other") for r in ring]
    assert read(metric, record, bare) is None


def test_train_step_phases_make_the_root_and_the_trainer_line_reads_them():
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.data.device_prefetch import DevicePrefetcher
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr
    from monodetr_torch.train.optimizer import build_optimizer
    from monodetr_torch.train.synthetic import SyntheticLoader
    from monodetr_torch.train.train_step import make_train_step
    from monodetr_torch.train.trainer import PHASES, host_line

    cfg = dict(MONODETR_MODEL, enc_layers=1, dec_layers=2, dtype="float32")
    model = build_monodetr(cfg, seed=0)
    step = make_train_step(model, SetCriterion(cfg),
                           build_optimizer({"type": "adamw", "lr": 2e-4}, model))
    gen = torch.Generator().manual_seed(0)
    n = 3
    for i, (on_card, _, _) in enumerate(DevicePrefetcher(SyntheticLoader(n, 1, 0, 64, 128),
                                                         "cpu")):
        step(on_card, 2e-4, gen)
        if i == n - 1:  # as the trainer reads it, before the loader's end
            line = host_line(n)
            waits = trace.last("data wait", n)
    roots = trace.last("train step", n)
    assert len(roots) == len(waits) == n
    for r in roots:
        took = r.end_ns - r.start_ns
        assert set(PHASES) | {"matcher", "backbone", "encoder", "decoder"} <= set(r.spans)
        assert sum(r.spans[p] for p in PHASES) + r.self_ns == pytest.approx(took, rel=0.01)
        assert r.self_ns < 0.5 * took
    got = dict(f.rsplit(" ", 1) for f in line.split("host ms/step ")[1].split(", "))
    assert list(got) == list(PHASES) + ["data wait"]
    for p in PHASES:
        assert float(got[p]) == pytest.approx(
            sum(r.spans[p] for r in roots) / n / 1e6, abs=0.051)
    assert float(got["data wait"]) == pytest.approx(
        sum(r.end_ns - r.start_ns for r in waits) / n / 1e6, abs=0.051)


def test_stream_readers_on_the_program_s_own_roots():
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.data.kitti_utils import Calibration
    from monodetr_torch.eval.decode import decode_detections
    from monodetr_torch.models.monodetr import build_monodetr
    from monodetr_torch.train.synthetic import SyntheticLoader
    from monodetr_torch.train.train_step import batch_to_device, make_eval_step

    model = build_monodetr(dict(MONODETR_MODEL, enc_layers=1, dec_layers=1, dtype="float32"),
                           seed=0)
    eval_step = make_eval_step(model, topk=5)
    keys = ("images", "calibs", "img_sizes")
    # one warm-up frame, two in the window, one profiled
    for batch, infos in SyntheticLoader(4, 1, 0, 64, 128):
        on_card = batch_to_device(batch, "cpu", keys)
        dets = eval_step(*(on_card[k] for k in keys)).numpy()
        info = {"img_id": [i["img_id"] for i in infos], "img_size": [i["img_size"] for i in infos]}
        decode_detections(dets, info, [Calibration.from_p2(batch["calibs"][0])],
                          np.zeros((3, 3), np.float32), 0.0)
    record = {"kind": "stream", "window": {"steps": 2}, "trace": {"steps": 1}}
    for metric, name in (("host_h2d_ms.stream", "batch_to_device"),
                         ("host_forward_ms.stream", "eval step"),
                         ("host_decode_ms.stream", "decode")):
        window = trace.last(name, 3)[:2]
        assert read(metric, record) == pytest.approx(
            sum(r.end_ns - r.start_ns for r in window) / 2 / 1e6)
    forward, = trace.last("eval step", 1)
    assert {"backbone", "encoder", "decoder"} <= set(forward.spans)


def _graph_ring(window_counts):
    """3 set-up frames (eager, capture, replay), the window's, 2 profiled
    replays; as the program writes them, with the other two roots."""
    replay = {"eval_graph_replay": 1, "msda_sep": 0}
    ring = []
    for counts in [{"msda_sep": 3}, {"eval_graph_capture": 1}, replay] + window_counts \
            + [replay] * 2:
        ring += [_root("batch_to_device", 1), _root("eval step", 3)._replace(counts=counts),
                 _root("decode", 1)]
    return ring


def test_eval_graph_share_reads_the_window_s_replays():
    replay, eager = {"eval_graph_replay": 1}, {"msda_enc_fused": 1}
    record = {"kind": "stream", "window": {"steps": 4}, "trace": {"steps": 2}}
    ring = _graph_ring([replay, eager, replay, replay])
    assert read("eval_graph_share.stream", record, ring) == pytest.approx(75.0)
    assert read("eval_graph_share.stream", record, _graph_ring([replay] * 4)) == 100.0
    # the set-up's capture is the only root that counts the mechanism
    assert read("eval_graph_share.stream", record, _graph_ring([eager] * 4)) == 0.0
    assert read("eval_graph_share.stream", TRAIN_RECORD, ring + _train_ring()) is None
    assert read("eval_graph_share.stream", record, ring[-9:]) is None  # window out of the ring
    # a program without the graph: its roots count kernels only
    parent = [r._replace(counts=eager) if r.name == "eval step" else r for r in ring]
    assert read("eval_graph_share.stream", record, parent) is None
    assert read("eval_graph_share.stream", record, _stream_ring()) is None


def _train_graph_ring(window_counts):
    """2 set-up steps (eager, capture), the window's, 2 profiled replays;
    as the program writes them, with the prefetcher's roots between."""
    replay = {"train_graph_replay": 1, "lap": 1}
    ring = []
    for counts in [{"msda_enc_fused": 3, "lap": 1}, {"train_graph_capture": 1}] \
            + window_counts + [replay] * 2:
        ring += [_root("data wait", 1), _root("train step", 30)._replace(counts=counts)]
    return ring


def test_train_graph_share_reads_the_window_s_replays():
    replay, eager = {"train_graph_replay": 1, "lap": 1}, {"msda_enc_fused": 3, "lap": 1}
    record = {"kind": "train", "window": {"steps": 4}, "trace": {"steps": 2}}
    ring = _train_graph_ring([replay, eager, replay, replay])
    assert read("train_graph_share.train", record, ring) == pytest.approx(75.0)
    assert read("train_graph_share.train", record, _train_graph_ring([replay] * 4)) == 100.0
    # the set-up's capture is the only root that counts the mechanism
    assert read("train_graph_share.train", record, _train_graph_ring([eager] * 4)) == 0.0
    assert read("train_graph_share.train", STREAM_RECORD, ring + _stream_ring()) is None
    assert read("train_graph_share.train", record, ring[-9:]) is None  # window out of the ring
    # a program without the graphs: its roots count kernels only
    parent = [r._replace(counts=eager) if r.name == "train step" else r for r in ring]
    assert read("train_graph_share.train", record, parent) is None
    assert read("train_graph_share.train", record, _train_ring()) is None
    assert read("train_graph_share.train", TRAIN_RECORD, _graph_ring([{}] * 3)) is None


def test_the_train_step_on_the_cpu_never_captures():
    """On the CPU every step runs eagerly: no root counts a capture or a
    replay, and every step's root holds the spans inside the segments."""
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr
    from monodetr_torch.train.optimizer import build_optimizer
    from monodetr_torch.train.synthetic import SyntheticLoader
    from monodetr_torch.train.train_step import batch_to_device, make_train_step

    cfg = dict(MONODETR_MODEL, enc_layers=1, dec_layers=1, dtype="float32")
    model = build_monodetr(cfg, seed=0)
    opt = build_optimizer({"type": "adamw"}, model)
    step = make_train_step(model, SetCriterion(cfg), opt)
    gen = torch.Generator().manual_seed(0)
    before = trace.counts()
    for b, _ in SyntheticLoader(3, 1, 0, 64, 128):
        step(batch_to_device(b, "cpu"), 2e-4, gen)
    for r in trace.last("train step", 3):
        assert not {"train_graph_capture", "train_graph_replay"} & set(r.counts)
        assert {"backbone", "encoder MSDA", "decoder MSDA", "matcher"} <= set(r.spans)
    after = trace.counts()
    for c in ("train_graph_capture", "train_graph_replay"):
        assert after.get(c, 0) == before.get(c, 0)
    assert opt.step_count == 3 and float(opt.t) == 3.0


def test_segments_run_in_their_span_or_go_to_the_routed_runner():
    """segment(name, fn, *args) is fn(*args) inside span(name) (no span for
    None); routed(run) hands the calls on its thread to run(name, fn,
    args), and routed(None) inside it runs them as written again."""
    from monodetr_torch.utils.segments import routed, segment

    with span("seg root"):
        assert segment("seg inner", lambda a, b: a + b, 2, 3) == 5
        assert segment(None, lambda: 7) == 7
    root, = trace.last("seg root", 1)
    assert set(root.spans) == {"seg inner"}
    calls = []

    def run(name, fn, args):
        calls.append((name, args))
        with routed(None):
            return fn(*args)

    with routed(run):
        assert segment("seg inner", lambda a: segment("nested", lambda: a * 2), 4) == 8
    assert calls == [("seg inner", (4,))]
    assert segment(None, lambda: 1) == 1 and len(calls) == 1


def test_the_eval_step_on_the_cpu_never_captures():
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.monodetr import build_monodetr
    from monodetr_torch.train.synthetic import SyntheticLoader
    from monodetr_torch.train.train_step import make_eval_step

    model = build_monodetr(dict(MONODETR_MODEL, enc_layers=1, dec_layers=1, dtype="float32"),
                           seed=0)
    eval_step = make_eval_step(model, topk=5)
    keys = ("images", "calibs", "img_sizes")
    batch, _ = next(iter(SyntheticLoader(1, 1, 0, 64, 128)))
    inputs = [torch.from_numpy(batch[k]) for k in keys]
    before = trace.counts()
    first = eval_step(*inputs)
    for _ in range(3):
        assert torch.equal(eval_step(*inputs), first)
    roots = trace.last("eval step", 4)
    assert len(roots) == 4
    for r in roots:
        assert not {"eval_graph_capture", "eval_graph_replay"} & set(r.counts)
        assert {"backbone", "encoder", "decoder"} <= set(r.spans)
    after = trace.counts()
    for c in ("eval_graph_capture", "eval_graph_replay"):
        assert after.get(c, 0) == before.get(c, 0)


def test_the_graph_key_follows_what_a_capture_records_and_the_state_the_addresses():
    """StepGraphs.key, the one key of both steps' graphs, changes with the
    model inputs' shapes and dtypes, every module's plain_ops, CUDA
    autocast's state and dtype, either TF32 switch and the generator, and
    not with the inputs' values; StepGraphs.state changes when a
    parameter moves or is replaced in its module or a buffer is replaced,
    and not when weights are written in place."""
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.monodetr import build_monodetr
    from monodetr_torch.train.train_step import StepGraphs

    model = build_monodetr(dict(MONODETR_MODEL, enc_layers=1, dec_layers=1, dtype="float32"),
                           seed=0)
    graphs = StepGraphs(model, "eval")
    inputs = (torch.zeros(1, 64, 128, 3), torch.zeros(1, 3, 4), torch.zeros(1, 2))
    base = graphs.key(inputs)
    assert graphs.key(tuple(x + 1 for x in inputs)) == base
    keys = [base, graphs.key((torch.zeros(2, 64, 128, 3),) + inputs[1:]),
            graphs.key(inputs[:2] + (inputs[2].double(),)),
            graphs.key(inputs, torch.Generator()), graphs.key(inputs, torch.Generator())]
    model.use_plain_ops(True)
    keys.append(graphs.key(inputs))
    model.use_plain_ops(False)
    amp = torch.is_autocast_enabled("cuda"), torch.get_autocast_dtype("cuda")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.set_autocast_enabled("cuda", True)  # torch.autocast("cuda") is off without a card
        for dtype in (torch.bfloat16, torch.float16):
            torch.set_autocast_dtype("cuda", dtype)
            keys.append(graphs.key(inputs))
        torch.set_autocast_enabled("cuda", False)
        torch.backends.cuda.matmul.allow_tf32 = not tf32[0]
        keys.append(graphs.key(inputs))
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.backends.cudnn.allow_tf32 = not tf32[1]
        keys.append(graphs.key(inputs))
    finally:
        torch.set_autocast_enabled("cuda", amp[0])
        torch.set_autocast_dtype("cuda", amp[1])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert len(set(keys)) == len(keys) == 10
    assert graphs.key(inputs) == base

    state = graphs.state()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    assert graphs.state() == state
    states = [state]
    head = model.class_embed[0]
    head.bias = torch.nn.Parameter(head.bias.detach().clone())
    states.append(graphs.state())
    weight = next(model.parameters())
    weight.data = weight.data.clone()
    states.append(graphs.state())
    module, name = next((m, k) for m in model.modules() for k, v in m._buffers.items()
                        if v is not None)
    setattr(module, name, getattr(module, name).clone())
    states.append(graphs.state())
    assert len(set(states)) == 4 and graphs.state() == states[-1]


def test_device_constant_inside_held_constants_takes_and_keeps_its_tables():
    from monodetr_torch.ops.utils import device_constant, held_constants, lid_bin_values

    cpu = torch.device("cpu")
    args = (7, 1e-3, 60.0)
    shared = device_constant(lid_bin_values, args, cpu)
    assert device_constant(lid_bin_values, args, cpu) is shared  # the cache's
    tables = {}
    with held_constants(tables):
        held = device_constant(lid_bin_values, args, cpu)
    assert held is shared and tables == {(lid_bin_values, args, cpu): shared}
    device_constant.cache_clear()
    fresh = device_constant(lid_bin_values, args, cpu)
    assert fresh is not shared and torch.equal(fresh, shared)
    with held_constants(tables):  # the held table first, whatever the cache has
        assert device_constant(lid_bin_values, args, cpu) is shared
        inner = {}
        with held_constants(inner):
            assert device_constant(lid_bin_values, args, cpu) is fresh
        assert inner == {(lid_bin_values, args, cpu): fresh}
        seen = []  # another thread's calls are not held

        def other():
            seen.append(device_constant(lid_bin_values, args, cpu))

        t = threading.Thread(target=other)
        t.start()
        t.join(30)
        assert not t.is_alive() and seen[0] is fresh
    assert device_constant(lid_bin_values, args, cpu) is fresh
