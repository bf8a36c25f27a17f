"""The metric arithmetic on synthetic records: the window's rate, the 95th
percentile, idle time as a union of intervals, component attribution, the
roofline's least time; the frozen counts of every configuration file,
recomputed on the meta device, and the DINO reference's counts against the
standard's; the weights each configuration file's seed makes."""

import hashlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_h100.core import counts, spec, trace, weights

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "bench_h100"


def record(kind, **extra):
    rec = {"kind": kind, "setup_s": 31.5, "batch": 16, "peak_bytes": 3 * 2 ** 30,
           "counts": {"train_flops_per_img": 400e9, "eval_flops_per_img": 100e9,
                      "enc_msda_per_img_layer": counts.enc_msda_work(
                          {"num_feature_levels": 4, "hidden_dim": 256, "nheads": 8,
                           "enc_n_points": 4}, 384, 1280)},
           "model": {"enc_layers": 3},
           "window": {"seconds": 20.0, "steps": 100, "images": 1600, "host_s": 5.0,
                      "latencies_s": [i / 1000 for i in range(1, 101)]}}
    rec.update(extra)
    return rec


def read(name, rec):
    return spec.reader(name, BENCH)(rec)


def test_rates_and_host_time():
    assert read("train_img_per_s", record("train")) == 80.0
    assert read("train_img_per_s", record("stream")) is None
    assert read("host_ms.train", record("train")) == pytest.approx(50.0)
    assert read("setup_s", record("stream")) == 31.5
    assert read("peak_mem_gib.train", record("train")) == 3.0
    assert read("mfu.train", record("train")) == pytest.approx(100 * 400e9 * 80 / 989.4e12)


def test_p95_over_every_frame():
    assert read("frame_ms_p95", record("stream")) == pytest.approx(
        float(np.percentile(np.arange(1, 101), 95)))
    assert read("frame_ms_p95", record("train")) is None


def test_idle_is_one_minus_the_union_of_intervals():
    # three steps: [0, 100) and [50, 150) overlap, [200, 260) apart -> 210 us busy
    ops = [(0.0, 100.0, "a", "g"), (50.0, 150.0, "b", "g"), (200.0, 260.0, "c", "g")]
    assert trace.busy_intervals(ops) == [[0.0, 150.0], [200.0, 260.0]]
    assert trace.busy_us(ops) == 210.0
    tr = {"ops": ops, "components": {}, "steps": 3, "gaps": []}
    rec = record("train", trace=tr)
    rec["window"] = dict(rec["window"], seconds=0.0003, steps=3)  # 100 us a step
    assert read("device_idle.train", rec) == pytest.approx(100 * (1 - 70 / 100))
    assert trace.by_group(ops) == {"g": pytest.approx(0.26)}


def _event(name, start, end, parent=None, seq=-1, scope=0, kernels=(), thread=1):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           cpu_parent=parent, sequence_nr=seq, scope=scope, thread=thread,
                           fwd_thread=thread, kernels=[SimpleNamespace(duration=d)
                                                       for d in kernels],
                           device_type=torch.autograd.DeviceType.CPU)


def test_component_attribution_gives_backward_kernels_to_the_forward_range():
    rng = _event("component::encoder", 0, 10)
    fwd = _event("aten::mm", 1, 2, parent=rng, seq=7, kernels=(300.0,))
    node = _event("autograd::engine::evaluate_function: MmBackward0", 20, 30, seq=7)
    bwd = _event("aten::mm", 21, 22, parent=node, kernels=(500.0,))
    loose = _event("aten::add", 40, 41, kernels=(100.0,))
    comps = dict((id(e), c) for c, e in trace.event_components([rng, fwd, node, bwd, loose]))
    assert comps[id(fwd)] == "encoder" and comps[id(bwd)] == "encoder"
    assert comps[id(loose)] == "other"
    rec = trace.reduce_profile([rng, fwd, node, bwd, loose], 2)
    assert rec["components"] == {"encoder": 0.8, "other": 0.1}
    tr = dict(rec, ops=[(0.0, 1.0, "k", "g")])
    assert read("encoder_ms.train", record("train", trace=tr)) == pytest.approx(0.4)


def test_roofline_least_time():
    work = {"fwd": {"bf16_flops": 989.4e9, "f32_ops": 67e9, "bytes": 3.35e9 / 2},
            "bwd": {"bf16_flops": 0.0, "f32_ops": 67e9, "bytes": 0.0}}
    # per image and layer: 1 ms of bf16 products, 2 ms of f32 operations, 0.5 ms of bytes
    assert counts.least_ms(work, ("fwd", "bwd"), 2, 3) == pytest.approx(12.0)
    assert counts.least_ms(work, ("fwd",), 1, 1) == pytest.approx(1.0)
    w = counts.enc_msda_work({"num_feature_levels": 4, "hidden_dim": 256, "nheads": 8,
                              "enc_n_points": 4}, 384, 1280)
    S = 48 * 160 + 24 * 80 + 12 * 40 + 6 * 20
    assert w["fwd"]["f32_ops"] == 8 * S * 8 * 16 * 32
    assert w["bwd"]["bf16_flops"] == 2 * w["fwd"]["bf16_flops"] == 4 * S * 256 * (256 + 384)
    tr = {"ops": [(0.0, 1.0, "k", "g")], "components": {"encoder MSDA": 20.0}, "steps": 2,
          "gaps": []}
    least = counts.least_ms(w, ("fwd", "bwd"), 16, 3)
    assert read("enc_msda_roofline.train", record("train", trace=tr)) == pytest.approx(
        100 * least / 10.0)


@pytest.mark.parametrize("name", ["monodetr_r50_384x1280", "monodetr_r101_768x2560"])
def test_frozen_counts_match_the_configuration_file(name):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert counts.frozen_counts(config) == config["counts"]


@pytest.mark.parametrize("name,leaves,digest", [
    ("monodetr_r50_384x1280", 536,
     "d761e743c9fbb564b6418888c5f1b2bfb7523d55d15fbf434599c2bde9fcf388"),
    ("monodetr_r101_768x2560", 791,
     "bd515f05b6ba3c0fddfdd1a6aa628d657a89ca65cfe88d26695a12e456b7c6e7")])
def test_weights_of_a_seed_are_unchanged(name, leaves, digest):
    """Every leaf's name and bytes, in order, as the weights were made when
    the cells' limits were measured (the sums frozen here)."""
    config = spec.load_config(name)
    state = weights.make_state(spec.reference(config), 2 ** 31 + 5, config, "cpu")
    h = hashlib.sha256()
    for n, t in state.items():
        h.update(n.encode())
        h.update(t.contiguous().numpy().tobytes())
    assert (len(state), h.hexdigest()) == (leaves, digest)


def test_dino_counts_add_the_proposal_branch_and_the_query_positions():
    """At 384x1280 (S = 10,200 tokens) the training step of DINO's query
    path counts, beyond the standard path's: the proposal branch's forward
    over every token (its outputs reach no loss, so it has no backward),
    and in each of the three decoder layers the query position's MLP of the
    768-wide sine embedding (its input needs no gradient), and in the two
    after the first the query scale's MLP; less the standard path's
    reference-point layer."""
    config = spec.load_config("monodetr_r50_384x1280")
    m = config["model"]
    dino = dict(config, model=dict(m, two_stage_dino=True),
                reference=dict(config["reference"], model="dino"))
    got, base = counts.frozen_counts(dino), counts.frozen_counts(config)
    S, d, layers = 48 * 160 + 24 * 80 + 12 * 40 + 6 * 20, m["hidden_dim"], m["dec_layers"]
    proposal = 2 * S * d * (d + m["num_classes"] + d + d + 6)
    for train, Q in ((True, m["num_queries"] * m["group_num"]), (False, m["num_queries"])):
        passes = 3 if train else 1  # forward, input and weight gradients
        head = 2 * Q * (6 * 128 * d + d * d) + (2 * Q * 6 * 128 * d + 4 * Q * d * d) * train
        scale = passes * 2 * (2 * Q * d * d)
        ref_points = passes * 2 * Q * d * 2
        want = proposal + layers * head + (layers - 1) * scale - ref_points
        key = "train_flops_per_img" if train else "eval_flops_per_img"
        assert got[key] - base[key] == want, (key, got[key] - base[key], want)
    assert 6.5e9 < got["train_flops_per_img"] - base["train_flops_per_img"] < 7.5e9
