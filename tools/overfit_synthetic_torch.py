"""Learning-loop check of monodetr_torch: overfit the SHIPPED config on
synthetic KITTI (the twin of tools/overfit_synthetic.py, with its
make_config and parse_results).

KITTI AP parity cannot be run here (no dataset, no trained checkpoint).
This tool trains the shipped configuration (windowed `fused` encoder MSDA,
bf16, grouped queries, the reference AdamW) on a few synthetic images with
val == train, through the port's own CLI (tools/train_val_torch.py: its
loader, the handoff to the card, trainer, tester and the official KITTI
evaluation), and reads the loss and the val-on-train AP from its logs: the
whole learning system converges end to end, not just each stage against
the JAX package.

Writes outputs/overfit_synthetic_torch.json (the JAX tool's keys) for a
run of the config's msda_impl, and merges every run's losses and AP into
outputs/overfit_clamp_ab_torch.json under its msda_impl (the layout of
outputs/overfit_clamp_ab.json), so a default run and a `--msda-impl
gather` run give the clamp-semantics A/B.

Usage:  python tools/overfit_synthetic_torch.py [--images 8] [--epochs 300]
            [--msda-impl gather] [--out PATH] [--ab-out PATH]
            [--workdir DIR] [--device cuda]
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# by file: a `tests` package installed elsewhere would shadow this one
sys.path.insert(1, os.path.join(REPO, "tests"))

import yaml  # noqa: E402


def make_config(workdir, data_root, images, epochs, msda_impl=None):
    with open(os.path.join(REPO, "configs", "monodetr.yaml")) as f:
        cfg = yaml.safe_load(f)
    if msda_impl:
        # clamp-semantics A/B: 'fused' (the shipped windowed kernel) vs
        # 'gather' (exact reference semantics) on identical seed/data
        cfg["model"]["msda_impl"] = msda_impl

    # overfit protocol: augmentation off, val == train, tiny LR schedule
    cfg["dataset"].update(
        root_dir=str(data_root),
        batch_size=images,   # one batch per epoch
        aug_pd=False,
        aug_crop=False,
        random_flip=0.0,
        random_crop=0.0,
    )
    # model and kernels stay as shipped (bf16, 3+3 layers)
    cfg["model_name"] = "overfit"
    cfg["trainer"].update(max_epoch=epochs, save_frequency=epochs)
    cfg["lr_scheduler"]["decay_list"] = [int(epochs * 0.7), int(epochs * 0.9)]
    cfg["tester"].update(mode="single", checkpoint=epochs, threshold=0.2)

    cfg_path = os.path.join(workdir, "overfit.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg_path


def parse_results(output_dir):
    """Loss endpoints + final AP table from the train logs."""
    logs = []
    for f in sorted(os.listdir(output_dir)):
        if f.startswith("train.log"):
            with open(os.path.join(output_dir, f)) as fh:
                logs.append(fh.read())
    log = "\n".join(logs)

    losses = [float(m) for m in re.findall(r"loss_detr ([0-9.]+)", log)]
    # official-eval AP lines: "Car AP(_R40)?@0.70, 0.70, 0.70:" then
    # "bbox AP:a, b, c" / "bev AP:..." / "3d AP:..."
    aps = {}
    blocks = re.findall(
        r"Car AP(_R40)?@([0-9., ]+):\s*\n"
        r"\s*bbox\s+AP:([0-9.,\s]+)\n\s*bev\s+AP:([0-9.,\s]+)\n"
        r"\s*3d\s+AP:([0-9.,\s]+)", log)
    for r40, thresh, bbox, bev, ap3d in blocks[-2:]:
        key = "Car_AP" + ("_R40" if r40 else "") + "@" + thresh.split(",")[0].strip()
        aps[key] = {
            "bbox": [float(x) for x in bbox.split(",")],
            "bev": [float(x) for x in bev.split(",")],
            "3d": [float(x) for x in ap3d.split(",")],
        }
    return losses, aps, log


def merge_ab(path, impl, result):
    """Add one run to the A/B record at `path`, in the layout of
    outputs/overfit_clamp_ab.json."""
    ab = {}
    if os.path.exists(path):
        with open(path) as f:
            ab = json.load(f)
    ab.update(protocol="tools/overfit_synthetic_torch.py, identical seed/data/epochs; shipped "
                       "config (bf16, G=6 window for fused) vs exact-gather",
              epochs=result["epochs"], images=result["images"])
    ab[impl] = {"loss_first": result["loss_first"], "loss_last": result["loss_last"],
                "ap": result["final_ap"]}
    ab[f"ap3d_r40_{impl}"] = result["final_ap"].get("Car_AP_R40@0.70", {}).get("3d")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(ab, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--workdir", default=os.path.join(REPO, "tmp", "overfit_synthetic_torch"))
    ap.add_argument("--msda-impl", default=None,
                    help="override model.msda_impl (fused|gather|...) for "
                         "the clamp-semantics AP A/B")
    ap.add_argument("--out", default=None,
                    help="default outputs/overfit_synthetic_torch.json for the config's "
                         "impl; none with --msda-impl")
    ap.add_argument("--ab-out", default=os.path.join(REPO, "outputs",
                                                     "overfit_clamp_ab_torch.json"))
    ap.add_argument("--device", default="cuda", help="the CLI's --device")
    args = ap.parse_args(argv)

    with open(os.path.join(REPO, "configs", "monodetr.yaml")) as f:
        config_impl = yaml.safe_load(f)["model"]["msda_impl"]
    impl = args.msda_impl or config_impl
    workdir = os.path.join(args.workdir, impl)
    os.makedirs(workdir, exist_ok=True)
    data_root = os.path.join(workdir, "kitti")

    from synthetic_kitti import make_synthetic_kitti
    if not os.path.exists(os.path.join(data_root, "ImageSets", "train.txt")):
        make_synthetic_kitti(data_root, n_train=args.images, n_val=2, seed=3,
                             max_cars=6)
    # val == train: the eval measures pure memorization capacity
    with open(os.path.join(data_root, "ImageSets", "train.txt")) as f:
        train_ids = f.read()
    with open(os.path.join(data_root, "ImageSets", "val.txt"), "w") as f:
        f.write(train_ids)

    cfg_path = make_config(workdir, data_root, args.images, args.epochs, args.msda_impl)
    output_dir = os.path.join(workdir, "outputs", "overfit")
    shutil.rmtree(output_dir, ignore_errors=True)  # logs of an earlier run
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "train_val_torch.py"),
         "--config", cfg_path, "--device", args.device],
        cwd=workdir, text=True, timeout=7200)
    losses, aps, log = parse_results(output_dir)

    result = {
        "rc": proc.returncode,
        "epochs": args.epochs,
        "images": args.images,
        "msda_impl": args.msda_impl or f"{config_impl} (config default)",
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "loss_trajectory_every10": losses[::10],
        "final_ap": aps,
    }
    out = args.out or (None if args.msda_impl else
                       os.path.join(REPO, "outputs", "overfit_synthetic_torch.json"))
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(result, f, indent=2)
    if args.ab_out:
        merge_ab(args.ab_out, impl, result)
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["rc"] == 0 else 1)
