"""Windowed-clamp semantics validation of monodetr_torch (the twin of
tools/validate_clamp.py, with its flags, batches and JSON keys).

The windowed encoder impls (`fused`, `pallas`, `sepwin`) clamp sampling
offsets to a +-(G/2-1) px window around each query's static centre and
shrink the offset-bias ring to 0.75 (G/2-1) (models/msda_module.py); the
`gather` impl samples where the offsets point, as the reference's
ms_deform_attn_core_pytorch does.  This script measures whether the
difference matters in training:

  1. train two models N steps from IDENTICAL parameters (the windowed
     impl's init from seed 0, loaded into the gather model) on the same
     batches and the same dropout draws (step i's generator is seeded
     1000 + i, as the JAX tool's PRNGKey(1000 + i)), differing ONLY in
     msda_impl: gather vs the windowed impl; record both loss
     trajectories.  bf16 compute under autocast with f32 parameters (the
     shipped dtype), the reference AdamW, lr 2e-4 with 50 warm-up steps;
  2. cross-impl forward agreement: the f32 eval forward under BOTH impls on
     each model's trained parameters, and the decoded top-k detections
     compared (score, class, 2-D box).

On the card the windowed impl runs kernels 1 (`fused`), 5 (`pallas`) or
6 (`sepwin`), and both models run kernels 2-4; `gather` is plain PyTorch.
The JAX tool trained in f32 (its MonoDETR's default dtype), so its
trajectories are not this one's.  Writes
outputs/clamp_validation_g<window>_torch.json (never a JAX record) and
prints a summary.

    python tools/validate_clamp_torch.py [--steps 300] [--batch 8] [--impl pallas]
        [--window 8] [--height 384] [--width 1280] [--out PATH] [--device cuda]
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from monodetr_torch.config import MONODETR_MODEL  # noqa: E402
from monodetr_torch.models.criterion import SetCriterion  # noqa: E402
from monodetr_torch.models.monodetr import build_monodetr  # noqa: E402
from monodetr_torch.train.optimizer import build_optimizer  # noqa: E402
from monodetr_torch.train.train_step import (  # noqa: E402
    batch_to_device, make_eval_step, make_train_step)


def make_batch(rng, B, H, W):
    """The JAX tool's batch as numpy arrays, drawn from `rng` in its order."""
    T = 50
    calib = np.array(
        [[721.54, 0.0, 609.56, 44.86],
         [0.0, 721.54, 172.85, 0.22],
         [0.0, 0.0, 1.0, 0.003]], np.float32)
    n_obj = rng.randint(3, 12, B)
    mask = np.arange(T)[None] < n_obj[:, None]
    return {
        "images": rng.randn(B, H, W, 3).astype(np.float32),
        "calibs": np.tile(calib[None], (B, 1, 1)),
        "img_sizes": np.tile(np.array([[1242.0, 375.0]], np.float32), (B, 1)),
        "labels": rng.randint(0, 3, (B, T)).astype(np.int32),
        "boxes": np.concatenate(
            [rng.rand(B, T, 2) * 0.8 + 0.1,
             rng.rand(B, T, 2) * 0.15 + 0.03], -1).astype(np.float32),
        "boxes_3d": np.concatenate(
            [rng.rand(B, T, 2) * 0.8 + 0.1,
             rng.rand(B, T, 4) * 0.12 + 0.02], -1).astype(np.float32),
        "depth": (rng.rand(B, T, 1) * 55 + 3).astype(np.float32),
        "size_3d": (rng.rand(B, T, 3) * 1.5 + 0.8).astype(np.float32),
        "heading_bin": rng.randint(0, 12, (B, T, 1)).astype(np.int32),
        "heading_res": (rng.randn(B, T, 1) * 0.2).astype(np.float32),
        "mask": mask,
    }


def model_config(impl, window):
    return dict(MONODETR_MODEL, msda_impl=impl, msda_window=window)


def train_one(impl, window, state0, batches, steps, lr_peak, warmup, device):
    """(trained model, loss_detr of every step)."""
    cfg = model_config(impl, window)
    model = build_monodetr(cfg)
    model.load_state_dict(state0)
    model.to(device)
    optimizer = build_optimizer({"type": "adamw", "lr": lr_peak, "weight_decay": 1e-4}, model)
    train_step = make_train_step(model, SetCriterion(cfg), optimizer, torch.bfloat16)
    traj = []
    t0 = time.time()
    gen = torch.Generator(device=device)  # one generator, so the step's CUDA graphs replay
    for i in range(steps):
        lr = lr_peak * min(1.0, (i + 1) / warmup)
        gen.manual_seed(1000 + i)
        losses = train_step(batches[i % len(batches)], lr, gen)
        total = float(losses.as_dict()["loss_detr"])
        traj.append(total)
        if i % 25 == 0 or i == steps - 1:
            print(f"[{impl}] step {i}: loss_detr={total:.4f} ({time.time() - t0:.0f}s)",
                  flush=True)
    return model, traj


def detections(state, batch, impl, window, device):
    """[B, 50, 37] numpy: the f32 eval forward under `impl` on `state`."""
    model = build_monodetr(model_config(impl, window))
    model.load_state_dict(state)
    model.to(device)
    dets = make_eval_step(model, topk=50)(batch["images"], batch["calibs"], batch["img_sizes"])
    return dets.cpu().numpy()


def decode_agreement(state, batch, wimpl="pallas", window=8, threshold=0.2, device="cuda"):
    """Top-k decode under gather vs the windowed impl's forward on the same
    parameters (match_detections)."""
    return match_detections(detections(state, batch, "gather", window, device),
                            detections(state, batch, wimpl, window, device), threshold)


def match_detections(a, b, threshold=0.2):
    """The share of a's confident detections (score > threshold) that b
    also has (same class, 2-D box within 0.2 in summed normalised
    coordinates), and their mean score gap.  a, b: [B, K, 37]; column 0 the
    class, 1 the score, 2:6 the 2-D box."""
    agree, total = 0, 0
    score_gap = []
    for i in range(a.shape[0]):
        sa = a[i][a[i, :, 1] > threshold]
        sb = b[i][b[i, :, 1] > threshold]
        total += len(sa)
        for d in sa:
            if len(sb) == 0:
                continue
            same_cls = sb[sb[:, 0] == d[0]]
            if len(same_cls) == 0:
                continue
            # nearest same-class detection by 2d-box center
            dist = np.abs(same_cls[:, 2:6] - d[2:6]).sum(-1)
            j = int(np.argmin(dist))
            if dist[j] < 0.05 * 4:  # avg 1.25% of image per box coord
                agree += 1
                score_gap.append(abs(float(same_cls[j, 1]) - float(d[1])))
    frac = agree / max(1, total)
    return {"n_confident_gather": int(total), "n_matched_in_pallas": int(agree),
            "match_frac": float(frac),
            "mean_score_gap": float(np.mean(score_gap)) if score_gap else None}


def summarize(results, impl):
    """The JAX tool's trajectory statistics, into `results`."""
    g = np.asarray(results["traj_gather"])
    p = np.asarray(results[f"traj_{impl}"])
    rel = np.abs(g - p) / np.maximum(np.abs(g), 1e-6)
    results["final_gather"] = float(g[-1])
    results["final_windowed"] = float(p[-1])
    results["final_rel_diff"] = float(rel[-1])
    results["max_rel_diff"] = float(rel.max())
    # smoothed tail comparison (last 20% of steps)
    k = max(1, len(g) // 5)
    results["tail_mean_gather"] = float(g[-k:].mean())
    results["tail_mean_windowed"] = float(p[-k:].mean())
    results["tail_rel_diff"] = float(
        abs(g[-k:].mean() - p[-k:].mean()) / abs(g[-k:].mean()))
    return results


def run(steps=300, batch=8, height=384, width=1280, impl="pallas", window=8, device="cuda",
        decode=True):
    """The validation's results dict (the JAX tool's keys)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    host = [make_batch(rng, batch, height, width) for _ in range(4)]
    batches = [batch_to_device(b, device) for b in host]

    # identical start: the windowed impl's init (its 0.75 (G/2 - 1) ring)
    state0 = build_monodetr(model_config(impl, window), seed=0).state_dict()

    results = {"steps": steps, "batch": batch, "resolution": [width, height],
               "impl": impl, "window": window}
    trained = {}
    for name in ("gather", impl):
        model, traj = train_one(name, window, state0, batches, steps, 2e-4, 50, device)
        trained[name] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        results[f"traj_{name}"] = traj
        del model
    summarize(results, impl)
    if decode:
        for on, name in (("windowed", impl), ("gather", "gather")):
            results[f"decode_agreement_on_{on}_params"] = decode_agreement(
                trained[name], batches[0], impl, window, device=device)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--impl", default="pallas",
                    help="windowed impl to validate against gather")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="default outputs/clamp_validation_g<window>_torch.json")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    if torch.device(args.device).type == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)

    results = run(args.steps, args.batch, args.height, args.width, args.impl, args.window,
                  args.device)
    out = args.out or os.path.join("outputs", f"clamp_validation_g{args.window}_torch.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({k: v for k, v in results.items()
                      if not k.startswith("traj")}, indent=1))
    print(f"written: {out}")


if __name__ == "__main__":
    main()
