"""Command-line entry point of monodetr_torch, with the flags of tools/train_val.py.

    python tools/train_val_torch.py --config configs/monodetr.yaml -e

`-e` evaluates: builds the model from the config's `model:` section
(seeded from `random_seed`), loads the tester's checkpoint if one is on
disk (a JAX-package checkpoint, converted), runs inference over the
`test_split` of the dataset and writes KITTI txt files under
<save_path>/<model_name>/outputs/data.  It runs on the CUDA card when one
is present and on the CPU otherwise.  Training is not ported yet.
"""

import argparse
import datetime
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from monodetr_torch.eval.tester import Tester  # noqa: E402
from monodetr_torch.models.monodetr import build_monodetr, compute_dtype  # noqa: E402
from monodetr_tpu.config import load_config  # noqa: E402
from monodetr_tpu.data import build_dataloader  # noqa: E402
from monodetr_tpu.utils.misc import create_logger, set_random_seed  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description="MonoDETR (PyTorch) monocular 3D detection")
    parser.add_argument("--config", dest="config", required=True, help="settings in yaml format")
    parser.add_argument("-e", "--evaluate_only", action="store_true",
                        help="evaluate model on validation set")
    args = parser.parse_args(argv)
    if not args.evaluate_only:
        raise NotImplementedError(
            "training is not ported to monodetr_torch yet (ROADMAP.md A7-A8); "
            "run with -e to evaluate")
    if not os.path.exists(args.config):
        raise FileNotFoundError(args.config)
    cfg = load_config(args.config)
    seed = cfg.get("random_seed", 444)
    set_random_seed(seed)

    model_name = cfg["model_name"]
    output_path = os.path.join("./" + cfg["trainer"].get("save_path", "outputs/"), model_name)
    os.makedirs(output_path, exist_ok=True)
    logger = create_logger(os.path.join(
        output_path, "eval.log.%s" % datetime.datetime.now().strftime("%Y%m%d_%H%M%S")))

    device = "cuda" if torch.cuda.is_available() else "cpu"
    logger.info("device: %s" % (torch.cuda.get_device_name(0) if device == "cuda" else "cpu"))
    _, test_loader = build_dataloader(cfg["dataset"])
    model = build_monodetr(cfg["model"], seed=seed).to(device, compute_dtype(cfg["model"]))
    logger.info("model params: %.2fM" % (sum(p.numel() for p in model.parameters()) / 1e6))

    logger.info("###################  Evaluation Only  ##################")
    tester = Tester(cfg=cfg["tester"], model=model, dataloader=test_loader, logger=logger,
                    train_cfg=cfg["trainer"], model_name=model_name, device=device)
    tester.test()


if __name__ == "__main__":
    main()
