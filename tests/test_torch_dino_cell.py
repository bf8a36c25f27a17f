"""The benchmark's DINO cell (`r50dino.train_bs16`: `two_stage_dino`,
DINO's mixed query selection) and the program's span and counters on the
decoder's first queries, on the CPU.

- The cell's configuration file, shrunk to 128x256 (680 encoder tokens,
  which hold the 550 training picks) at batch 2 and run in float32 through
  the harness's own loop (bench_h100/core/loops.py): the port's training
  steps agree with the plain float32 reference (bench_h100/reference/
  dino.py, given the port's picks and dropout masks) under the cell's own
  limits, and under float32 bounds far below them (FLOAT32_GAPS); the fp8
  precision control (bench_h100/control.py) fails `pick_excess` there.
  Every limit of limits/r50dino.train_bs16.json transfers to this size:
  the float32 port reads ~1e-7 on the loss and the first gradient and 0
  on the picks, the control ~0.4-0.6 on the picks.
- One CPU training step of a tiny model records the span `queries` under
  the step's `forward`, and under `two_stage_dino` counts the tokens
  scored (B x S) and the picks taken (B x K); the standard query path
  records the span and neither counter.
- The cell resolves by name to its configuration, the `dino` reference,
  the `train_bs16` mix and its limits, reports `train_img_per_s` and
  `queries_ms.train`, and its configuration departs from r50's in the
  DINO keys alone, with the counts that bench_h100/core/counts.py gives.
- `queries_ms.train` reads the `queries` component per profiled step, and
  None without a trace or where no window root counts `proposal_picks`.
"""

import os
import sys
import time

import pytest
import torch

from monodetr_torch.utils import trace
from monodetr_torch.utils.trace import Root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from bench_h100 import control  # noqa: E402
from bench_h100.core import check, counts, loops, spec  # noqa: E402

BENCH = os.path.join(REPO, "bench_h100")
CELL, CONFIG = "r50dino.train_bs16", "monodetr_r50dino_384x1280"
SEED = 2 ** 31 + 77
torch.set_num_threads(2)


def tiny_cell(dtype):
    """(config, mix, limits) of the cell at 128x256, batch 2, a pool of 3."""
    _, config, mix, limits, _, _ = spec.cell(CELL, REPO)
    config["input"] = {"height": 128, "width": 256}
    config["model"]["dtype"] = dtype
    config["reference"]["micro_batch"] = 1  # two passes, as the cell takes them
    config["counts"] = counts.frozen_counts(config)
    mix.update(batch=2, pool=3, warmup_steps=1)
    return config, mix, limits


# The cell's limits are set for bf16 on the card; in float32 on both sides
# the gaps are round-off.  Each bound is some 5-20x the greatest of six
# seeds' readings at this size (loss 4.7e-7, first gradient 1.3e-5, median
# change 4.8e-5, third leaf 0.0088: the K thirds of the packed attention
# biases, which Adam moves by round-off; match 0, picks 1.8e-7), and a 3%
# error in the decoder's query_scale reads 2.1e-4, 4.6e-4 and 5.9e-4 on
# the first three.
FLOAT32_GAPS = {"match_excess": 1e-3, "loss_gap": 1e-5, "grad_gap_median": 1e-4,
                "update_gap_median": 2e-4, "update_gap_3rd_leaf": 0.05, "pick_excess": 1e-5}


def test_the_cell_s_program_in_float32_agrees_with_the_reference_given_its_picks():
    config, mix, limits = tiny_cell("float32")
    record, correct, shown = loops.run(config, mix, limits, SEED, 0.2, False, "cpu",
                                       time.perf_counter())
    assert correct, record["numbers"]
    assert set(shown) == set(limits["limits"]) == set(FLOAT32_GAPS)
    for name, bound in FLOAT32_GAPS.items():
        assert record["numbers"][name] <= bound, (name, record["numbers"])
    assert record["window"]["images"] > 0


def test_the_fp8_control_fails_pick_excess_in_the_cell():
    config, mix, limits = tiny_cell("bf16")
    numbers, _ = control.train_control(config, mix, SEED, "cpu")
    assert numbers["pick_excess"] > limits["limits"]["pick_excess"], numbers
    assert not check.verdict(numbers, limits["limits"])[0]


@pytest.mark.parametrize("dino", [False, True])
def test_the_queries_span_under_forward_and_the_proposal_counters(dino):
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr
    from monodetr_torch.train.optimizer import build_optimizer
    from monodetr_torch.train.synthetic import SyntheticLoader
    from monodetr_torch.train.train_step import batch_to_device, make_train_step

    # 64x128: 170 tokens an image, which hold the 50 queries of one group
    cfg = dict(MONODETR_MODEL, enc_layers=1, dec_layers=1, dtype="float32", group_num=1,
               two_stage_dino=dino)
    model = build_monodetr(cfg, seed=0)
    step = make_train_step(model, SetCriterion(cfg),
                           build_optimizer({"type": "adamw", "lr": 2e-4}, model))
    B = 2
    batch = batch_to_device(next(iter(SyntheticLoader(1, B, 0, 64, 128)))[0], "cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(batch, 2e-4, gen)
    root, = trace.last("train step", 1)
    assert {"forward", "queries", "decoder"} <= set(root.spans)
    ranges = [e for e in prof.events() if e.name == trace.COMPONENT_PREFIX + "queries"]
    assert len(ranges) == 1
    parents, e = [], ranges[0].cpu_parent
    while e is not None:
        if e.name.startswith(trace.COMPONENT_PREFIX):
            parents.append(e.name[len(trace.COMPONENT_PREFIX):])
        e = e.cpu_parent
    assert parents == ["forward", "train step"]
    if dino:
        S = 8 * 16 + 4 * 8 + 2 * 4 + 1 * 2
        assert root.counts["proposal_tokens"] == B * S
        assert root.counts["proposal_picks"] == B * cfg["num_queries"] * cfg["group_num"]
    else:
        assert "proposal_tokens" not in root.counts and "proposal_picks" not in root.counts


def test_the_cell_resolves_its_files_metrics_and_counts():
    work, config, mix, limits, e2e, per_layer = spec.cell(CELL, REPO)
    bench = spec.benchmark(REPO)
    entry = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert work["config"] == CONFIG == config["name"] and work["chips"] == 1
    assert entry["reduced"] == config["reduced"] == []
    assert spec.reference(config).__name__ == "bench_h100.reference.dino"
    assert work["traffic"] == "train_bs16" and mix == spec.load_mix("train_bs16")
    assert limits == spec.load_limits(CELL) and "pick_excess" in limits["limits"]
    assert {"setup_s", "train_img_per_s"} == {m["name"] for m in e2e}
    names = {m["name"] for m in per_layer}
    _, _, _, _, _, r50_layers = spec.cell("r50.train_bs16", REPO)
    assert names == {m["name"] for m in r50_layers} | {"queries_ms.train"}
    for m in e2e + per_layer:
        assert callable(spec.reader(m["name"], BENCH))
    assert counts.frozen_counts(config) == config["counts"]
    # r50's configuration with DINO's keys and the counts they change
    r50 = spec.load_config("monodetr_r50_384x1280", REPO)
    assert {k for k in config if config[k] != r50[k]} == {
        "name", "source", "as_run", "model", "reference", "assumed", "counts"}
    assert {k: v for k, v in config["model"].items() if r50["model"][k] != v} == {
        "two_stage_dino": True}
    assert config["reference"] == dict(r50["reference"], model="dino")
    assert config["counts"] == dict(r50["counts"], train_flops_per_img=373_250_027_520,
                                    eval_flops_per_img=129_824_450_560)
    assert set(r50["assumed"]) < set(config["assumed"])


def _root(name, counted=None):
    return Root(name, 0, 1_000_000, 0, {}, counted or {})


def _ring(window):
    """2 set-up steps, the window's 3, 2 profiled, each with a prefetch wait."""
    picks = {"proposal_tokens": 20400, "proposal_picks": 1100}
    ring = []
    for counted in [picks, picks] + window + [picks, picks]:
        ring += [_root("data wait"), _root("train step", counted)]
    return ring


def test_queries_ms_reads_the_component_per_step_where_the_window_picks():
    read = spec.reader("queries_ms.train", BENCH)
    picks = {"proposal_tokens": 20400, "proposal_picks": 1100}
    tr = {"ops": [(0.0, 1.0, "k", "g")], "components": {"queries": 4.5, "decoder": 30.0},
          "steps": 2, "gaps": []}
    record = {"kind": "train", "window": {"steps": 3}, "trace": tr}
    assert read(record, _ring([picks] * 3)) == pytest.approx(2.25)
    assert read(record, _ring([{}, picks, {}])) == pytest.approx(2.25)
    # no trace: the window's roots alone, and no device time to read
    untraced = {"kind": "train", "window": {"steps": 3}}
    assert read(untraced, _ring([picks] * 3)[:-4]) is None
    # the standard query path, or a program without the counter
    assert read(record, _ring([{}] * 3)) is None
    assert read({"kind": "stream", "window": {"steps": 3}, "trace": tr},
                _ring([picks] * 3)) is None
    # the window's first root out of the ring
    assert read(record, _ring([picks] * 3)[-6:]) is None
