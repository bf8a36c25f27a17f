"""Convert a reference MonoDETR torch checkpoint (.pth), or a plain
torchvision ImageNet ResNet, into the checkpoint format that monodetr_torch
(and the JAX package) load; the twin of tools/convert_checkpoint.py's
command line, through the port's own converter (monodetr_torch/convert.py).

Usage:
    python tools/convert_checkpoint_torch.py <reference_ckpt.pth> <out_prefix>
        [--two-stage | --use-dab | --two-stage-dino]
    python tools/convert_checkpoint_torch.py <resnet50.pth> <out_prefix>
        --torchvision-backbone resnet50

The first writes a full checkpoint, for `tester.checkpoint_path` and
`tools/train_val_torch.py -e`; the second a backbone-only one, for
`trainer.pretrain_model`, which the Trainer merges into the model's init
(the reference's ImageNet start, backbone.py:100-102).  `<out_prefix>.pth`
is a pickle of {epoch, model_state, optimizer_state, best_result,
best_epoch}, `model_state` the flax parameter tree with numpy leaves.
The source is read with torch.load(weights_only=False), as a reference
checkpoint needs: convert only files you trust.
"""

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from monodetr_torch.convert import (  # noqa: E402
    convert_state_dict, convert_torchvision_backbone, tree_leaves)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("src")
    ap.add_argument("out_prefix")
    ap.add_argument("--torchvision-backbone", choices=["resnet50", "resnet101"],
                    help="treat src as a plain torchvision resnet state dict "
                         "and emit a backbone-only partial checkpoint "
                         "(for trainer.pretrain_model ImageNet init)")
    ap.add_argument("--two-stage", action="store_true",
                    help="checkpoint was trained with two_stage: true")
    ap.add_argument("--use-dab", action="store_true",
                    help="checkpoint was trained with use_dab: true")
    ap.add_argument("--two-stage-dino", action="store_true",
                    help="checkpoint was trained with two_stage_dino: true")
    args = ap.parse_args(argv)
    src, out_prefix = args.src, args.out_prefix
    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state", ckpt)
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    if args.torchvision_backbone:
        params = convert_torchvision_backbone(sd, args.torchvision_backbone)
        ckpt = {}
    else:
        params = convert_state_dict(
            sd, two_stage=args.two_stage, use_dab=args.use_dab,
            two_stage_dino=args.two_stage_dino,
        )

    state = {
        "epoch": ckpt.get("epoch", 0),
        "model_state": params,
        "optimizer_state": None,
        "best_result": ckpt.get("best_result", 0.0),
        "best_epoch": ckpt.get("best_epoch", 0),
    }
    with open(out_prefix + ".pth", "wb") as f:
        pickle.dump(state, f)
    n = sum(v.size for v in tree_leaves(params))
    print(f"converted {src} -> {out_prefix}.pth ({n/1e6:.2f}M params)")


if __name__ == "__main__":
    main()
