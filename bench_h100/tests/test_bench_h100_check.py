"""The output check on the CPU at 64x128: the program run in float32
agrees with the reference; each fault of core/faults.py planted in the
program makes `correct` false through the rest of a run (the look for a
card skipped); the fp8 control fails the limits; the reference's Philox
masks match the published test vectors (and, on a card, the program's
kernels' masks).  The same for DINO's query path (`two_stage_dino`,
reference/dino.py) at 128x256, whose 680 tokens hold the 550 training
picks, where the reference takes the program's picks and `pick_excess`
judges them."""

import contextlib
import json
import time
from pathlib import Path

import pytest
import torch

from bench_h100 import control
from bench_h100.core import check, counts, faults, loops
from bench_h100.reference import drops

BENCH = Path(__file__).resolve().parents[2] / "bench_h100"
CELLS = {"train": ("r50.train_bs16", "train_bs16"), "stream": ("r50.stream_bs1", "stream_bs1")}
# a provisional limit of the DINO cases, between the float32 program's
# first-step pick_excess here (~6e-7) and the fp8 control's (~0.5)
PICK_EXCESS = 0.05


def tiny(kind, dtype="bf16", dino=False):
    """(config, mix, limits) of a cell at 64x128 (DINO's at 128x256), two
    images a batch."""
    cell, traffic = CELLS[kind]
    config = json.loads((BENCH / "configs" / "monodetr_r50_384x1280.json").read_text())
    config["input"] = {"height": 128, "width": 256} if dino else {"height": 64, "width": 128}
    config["model"]["dtype"] = dtype
    config["reference"]["micro_batch"] = 1  # two passes, as a large cell takes them
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())["limits"]
    if dino:
        config["model"]["two_stage_dino"] = True
        config["reference"]["model"] = "dino"
        limits["pick_excess"] = PICK_EXCESS
    config["counts"] = counts.frozen_counts(config)
    mix = json.loads((BENCH / "mixes" / f"{traffic}.json").read_text())
    mix.update(batch=min(mix["batch"], 2), pool=3, warmup_batches=1, warmup_steps=1,
               check_frames=2)
    return config, mix, limits


def run(kind, fault=None, dtype="bf16", dino=False):
    config, mix, limits = tiny(kind, dtype, dino)
    ctx = faults.planted(kind, fault)() if fault else contextlib.nullcontext()
    with ctx:
        record, correct, shown = loops.run(config, mix, {"limits": limits}, 2 ** 31 + 77, 0.2,
                                           False, "cpu", time.perf_counter())
    return record, correct


@pytest.mark.parametrize("kind", ["train", "stream"])
def test_program_in_float32_agrees_with_the_reference(kind):
    record, correct = run(kind, dtype="float32")
    assert correct, record["numbers"]
    assert record["window"]["images"] > 0 and record["setup_s"] > 0


@pytest.mark.parametrize("kind,fault", [(k, f) for k in faults.FAULTS for f in faults.FAULTS[k]])
def test_a_fault_in_the_timed_path_is_not_correct(kind, fault):
    record, correct = run(kind, fault, dtype="float32")
    assert not correct, record["numbers"]


@pytest.mark.parametrize("kind", ["train", "stream"])
def test_the_fp8_control_fails_the_limits(kind):
    config, mix, limits = tiny(kind)
    numbers, _ = (control.train_control if kind == "train" else control.infer_control)(
        config, mix, 5, "cpu")
    correct, _ = check.verdict(numbers, limits)
    assert not correct, numbers


def test_dino_program_in_float32_agrees_with_the_reference_given_its_picks():
    record, correct = run("train", dtype="float32", dino=True)
    assert correct, record["numbers"]
    assert record["numbers"]["pick_excess"] <= 1e-5, record["numbers"]


@pytest.mark.parametrize("fault", list(faults.FAULTS["train"]) + list(faults.PICK_FAULTS["train"]))
def test_dino_a_fault_in_the_timed_path_is_not_correct(fault):
    record, correct = run("train", fault, dtype="float32", dino=True)
    assert not correct, record["numbers"]
    if fault in faults.PICK_FAULTS["train"]:
        # the picks are handed to the reference, so only pick_excess sees them
        assert record["numbers"]["pick_excess"] > PICK_EXCESS, record["numbers"]


def test_dino_the_fp8_control_fails_the_limits():
    config, mix, limits = tiny("train", dino=True)
    numbers, _ = control.train_control(config, mix, 5, "cpu")
    correct, _ = check.verdict(numbers, limits)
    assert not correct, numbers


def test_pick_excess_reads_order_set_and_repeats():
    scores = [[3.0, 1.0, 2.0, 0.5]]
    assert check.pick_excess([[0, 2]], scores) == 0.0
    assert check.pick_excess([[2, 0]], scores) == 1.0  # order swapped
    assert check.pick_excess([[0, 1]], scores) == 1.0  # a wrong set
    assert check.pick_excess([[0, 0]], scores) == float("inf")
    assert check.pick_excess([[0, 2], [0, 2]], scores) == float("inf")


def test_philox_known_answers():
    """Random123's known-answer vectors of Philox4x32-10."""
    def words(ctr, key):
        c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
        return [int(w) for w in drops.philox4x32_10(*c, *key)]

    assert words([0, 0, 0, 0], [0, 0]) == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8]
    assert words([0xffffffff] * 4, [0xffffffff] * 2) == [0x408f276d, 0x41c83b0e, 0xa20bc7c6,
                                                          0x6d5451fd]
    assert words([0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344], [0xa4093822, 0x299f31d0]) \
        == [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]


@pytest.mark.cuda
def test_philox_mask_is_the_attention_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernel's own mask")
    from monodetr_torch.ops.attention import attention_keep_mask

    got = attention_keep_mask((2, 8, 70, 1923), 123456789, 0.1, "cuda")
    want = drops.philox_keep(123456789, 0.1, 0, 16, 0, 70, 1923, "cuda").view(2, 8, 70, 1923)
    assert torch.equal(got, want)
