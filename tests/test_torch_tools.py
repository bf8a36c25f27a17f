"""The port's validation tools (tools/validate_clamp_torch.py,
tools/overfit_synthetic_torch.py, tools/bench_loader_torch.py) and
profile_train's split by component, on the CPU.

- validate_clamp_torch's batches are the JAX tool's arrays from the same
  RandomState; its detection matching finds identical detections all
  matched and moved ones not; a 2-step run at 64x128 (fused G=6 against
  gather, full width, --device cpu) writes the JAX tool's JSON keys.
- overfit_synthetic_torch drives the port's CLI for one epoch on 2
  synthetic images with --device cpu; its parse_results reads the port
  trainer's log as the JAX tool's parse_results does; the A/B record
  takes the JAX record's layout.
- bench_loader_torch prints its loader lines without a card, and says
  the prefetched line is not measured.
- profile_train.event_components puts every operator of a CPU training
  step, forward and backward, in the span's range around it or around
  the forward operator whose autograd node it runs.
"""

import collections
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import bench_loader_torch  # noqa: E402
import overfit_synthetic  # noqa: E402
import overfit_synthetic_torch  # noqa: E402
import validate_clamp  # noqa: E402
import validate_clamp_torch  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("B,H,W", [(2, 16, 32), (1, 8, 24)])
def test_make_batch_is_the_jax_tools(B, H, W):
    rng_a, rng_b = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(2):  # the second batch too: the draws stay in step
        want = validate_clamp.make_batch(rng_a, B, H, W)
        got = validate_clamp_torch.make_batch(rng_b, B, H, W)
        assert got.keys() == want.keys()
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def detections(rng, B=2, K=50):
    d = rng.rand(B, K, 37).astype(np.float32)
    d[..., 0] = rng.randint(0, 3, (B, K))
    return d


def test_match_detections():
    rng = np.random.RandomState(4)
    a = detections(rng)
    n = int((a[..., 1] > 0.2).sum())
    r = validate_clamp_torch.match_detections(a, a.copy())
    assert r == {"n_confident_gather": n, "n_matched_in_pallas": n, "match_frac": 1.0,
                 "mean_score_gap": 0.0}
    # a box moved past the bound, or another class, no longer matches its
    # own row (it may still match another of its image's rows)
    b = a.copy()
    b[..., 2:6] += 0.3
    b[..., 0] = (b[..., 0] + 1) % 3
    moved = validate_clamp_torch.match_detections(a, b)
    assert moved["n_confident_gather"] == n and moved["match_frac"] < 1.0
    none = validate_clamp_torch.match_detections(a, np.zeros_like(a))
    assert none["match_frac"] == 0.0 and none["mean_score_gap"] is None


def test_validate_clamp_two_steps_on_the_cpu(tmp_path):
    out = tmp_path / "clamp.json"
    validate_clamp_torch.main(["--steps", "2", "--batch", "1", "--height", "64",
                               "--width", "128", "--impl", "fused", "--window", "6",
                               "--device", "cpu", "--out", str(out)])
    with open(out) as f:
        got = json.load(f)
    with open(os.path.join(REPO, "outputs", "clamp_validation_g6.json")) as f:
        jax_keys = json.load(f).keys()
    assert got.keys() == jax_keys
    assert got["steps"] == 2 and got["impl"] == "fused" and got["window"] == 6
    assert got["resolution"] == [128, 64]
    for k in ("traj_gather", "traj_fused"):
        assert len(got[k]) == 2 and np.isfinite(got[k]).all()
    # both start from the same parameters and batch: the first losses
    # differ only by the clamp and bf16
    assert abs(got["traj_gather"][0] - got["traj_fused"][0]) <= 0.1 * got["traj_gather"][0]
    assert 0.0 <= got["max_rel_diff"] and got["tail_rel_diff"] <= got["max_rel_diff"] + 1e-12
    for k in ("decode_agreement_on_windowed_params", "decode_agreement_on_gather_params"):
        assert got[k].keys() == {"n_confident_gather", "n_matched_in_pallas", "match_frac",
                                 "mean_score_gap"}


def test_overfit_one_cpu_epoch_through_the_cli(tmp_path):
    out, ab = tmp_path / "overfit.json", tmp_path / "ab.json"
    result = overfit_synthetic_torch.main(
        ["--images", "2", "--epochs", "1", "--workdir", str(tmp_path / "work"),
         "--out", str(out), "--ab-out", str(ab), "--device", "cpu"])
    assert result["rc"] == 0
    with open(out) as f:
        assert json.load(f) == result
    assert result["msda_impl"] == "fused (config default)" and result["epochs"] == 1
    assert result["loss_first"] > 0 and result["loss_first"] == result["loss_last"]
    assert result["loss_trajectory_every10"] == [result["loss_first"]]
    assert result["final_ap"].keys() == {"Car_AP@0.70", "Car_AP_R40@0.70"}
    for table in result["final_ap"].values():
        assert {k: len(v) for k, v in table.items()} == {"bbox": 3, "bev": 3, "3d": 3}

    # parse_results reads the port trainer's log as the JAX tool's does
    output_dir = tmp_path / "work" / "fused" / "outputs" / "overfit"
    log = "".join(p.read_text() for p in output_dir.glob("train.log.*"))
    assert "epoch 0 batch 0 | loss_detr" in log
    got, want = (m.parse_results(str(output_dir)) for m in (overfit_synthetic_torch,
                                                             overfit_synthetic))
    # (each trainer line names loss_detr twice, in the JAX trainer's format)
    assert got[:2] == want[:2] and got[0] == [result["loss_first"]] * 2

    # the A/B record, in the JAX record's layout, gains one impl a run
    with open(ab) as f:
        record = json.load(f)
    with open(os.path.join(REPO, "outputs", "overfit_clamp_ab.json")) as f:
        jax_record = json.load(f)
    assert record.keys() == {"protocol", "epochs", "images", "fused", "ap3d_r40_fused"}
    assert record["fused"].keys() == jax_record["fused"].keys()
    overfit_synthetic_torch.merge_ab(str(ab), "gather", result)
    with open(ab) as f:
        assert json.load(f).keys() == jax_record.keys()


def test_bench_loader_without_a_card(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bench_loader_torch.main(["--batches", "1", "--batch-size", "2", "--workers", "1,2",
                             "--mode", "thread", "--root", str(tmp_path / "kitti")])
    lines = capsys.readouterr().out.splitlines()
    rows = [ln for ln in lines if ln.startswith("mode=thread")]
    assert len(rows) == 3
    assert "batches/s" in rows[0] and "img/s" in rows[1]
    assert rows[2].endswith("through the prefetcher into the card: not measured "
                            "(no CUDA device)")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        bench_loader_torch.main(["--batches", "1", "--batch-size", "2", "--root",
                                 str(tmp_path / "kitti"), "--trainer-epochs", "1"])


def test_event_components_cover_the_step_forward_and_backward():
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr
    from monodetr_torch.profile_train import COMPONENTS, event_components
    from monodetr_torch.train.optimizer import build_optimizer
    from monodetr_torch.train.synthetic import SyntheticLoader
    from monodetr_torch.train.train_step import batch_to_device, make_train_step

    cfg = dict(MONODETR_MODEL, enc_layers=1, dec_layers=2, dtype="float32")
    model = build_monodetr(cfg, seed=0)
    step = make_train_step(model, SetCriterion(cfg),
                           build_optimizer({"type": "adamw", "lr": 2e-4}, model))
    batch = batch_to_device(next(iter(SyntheticLoader(1, 1, 0, 64, 128)))[0], "cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(batch, 2e-4, gen)
    by = collections.defaultdict(set)
    for comp, e in event_components(prof.events()):
        by[comp].add(e.name)
    assert set(by) == set(COMPONENTS)  # every operator of a CPU step in a span
    assert "aten::stack" in by["train step"]  # the loss vector
    assert "torch::autograd::AccumulateGrad" in by["backward"]
    # the backward's operators go to the forward's components
    assert "ConvolutionBackward0" in by["backbone"]
    assert "GridSampler2DBackward0" in by["encoder MSDA"]
    assert "GridSampler2DBackward0" in by["decoder MSDA"]
    assert "NativeLayerNormBackward0" in by["encoder"]
    assert "BmmBackward0" in by["decoder self-attention"]
    assert "BmmBackward0" in by["decoder depth cross-attention"]
    assert any(n.startswith("aten::_foreach") for n in by["optimizer"])
    assert not any("Backward" in n for n in by["matcher"])  # no gradient through it
    # a range is not an operator of its own
    assert not any(n.startswith("component::") for names in by.values() for n in names)
