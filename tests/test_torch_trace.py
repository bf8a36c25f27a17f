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
- The eval step's CUDA graph (train/train_step.py:make_eval_step): on the
  CPU it never captures; `eval_graph_share.stream` reads the window's
  share of replays, None for a program whose roots count no capture or
  replay; device_constant inside held_constants takes and keeps its
  tables (the graph's own behaviour is tests/test_torch_cuda.py's).
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


def _profiled_offsets():
    """(range names, ring start - range start in us of five roots) of one
    CPU profile."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # the first range of a profile pays the profiler's set-up after its start
        with span("profiled first"):
            pass
        for i in range(5):
            with span(f"profiled {i}"):
                with span("profiled child"):
                    torch.ones(4).sum()
            time.sleep(0.003)
    events = [e for e in prof.events() if e.name.startswith(trace.COMPONENT_PREFIX)]
    names = [e.name[len(trace.COMPONENT_PREFIX):] for e in events]
    starts = dict(zip(names, (e.time_range.start for e in events)))
    return names, [r.start_ns / 1e3 - starts[r.name] for i in range(5)
                   for r in trace.last(f"profiled {i}", 1)]


def test_spans_open_their_profiler_range_on_the_host_clock():
    # a busy host can preempt a thread between a range's start and the
    # clock's read: three profiles, one of which has to agree
    spreads = []
    for _ in range(3):
        names, offsets = _profiled_offsets()
        assert sorted(names) == sorted(["profiled first"] + [f"profiled {i}" for i in range(5)]
                                       + ["profiled child"] * 5)
        assert len(offsets) == 5
        spreads.append(max(offsets) - min(offsets))
        if spreads[-1] < 50.0:  # us
            break
    assert min(spreads) < 50.0, spreads


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
