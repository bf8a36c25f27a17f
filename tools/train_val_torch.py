"""Command-line entry point of monodetr_torch, with the flags of tools/train_val.py.

    python tools/train_val_torch.py --config configs/monodetr.yaml        # train
    python tools/train_val_torch.py --config configs/monodetr.yaml -e     # evaluate
    torchrun --nproc_per_node=N tools/train_val_torch.py --config ...   # data parallel

Both build the model from the config's `model:` section, seeded from
`random_seed`, on `--device` (default `cuda`; no CUDA card is an error,
never a quiet move to the CPU).  Training and `-e` keep f32 parameters
and run the forward in the config's compute dtype under autocast, as the
JAX tester does (tools/train_val.py:81-89); training saves JAX-format
checkpoints under <save_path>/<model_name>/ and evaluates every
`save_frequency` epochs unless the test split is `test`, then evaluates
the best checkpoint.  `-e` loads the tester's checkpoint if one is on disk
(a checkpoint of either package), writes KITTI txt files under
<save_path>/<model_name>/outputs/data and evaluates them.

Data parallel (tools/train_val.py:51-64) is `trainer.data_parallel: true`
under a launcher, or automatic when torchrun starts more than one process
(WORLD_SIZE > 1):
each process joins the group (NCCL on cuda:LOCAL_RANK, gloo with
`--device cpu`), loads its slice of every global batch (`batch_size` is
the global batch), and logs at its rank; rank 0 alone writes checkpoints
and evaluates.
"""

import argparse
import datetime
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from monodetr_torch.config import load_config  # noqa: E402
from monodetr_torch.data import build_dataloader  # noqa: E402
from monodetr_torch.eval.tester import Tester  # noqa: E402
from monodetr_torch.models.criterion import SetCriterion  # noqa: E402
from monodetr_torch.models.monodetr import build_monodetr, compute_dtype  # noqa: E402
from monodetr_torch.parallel.ddp import (  # noqa: E402
    DataParallel, init_distributed, rank_device)
from monodetr_torch.train.trainer import Trainer  # noqa: E402
from monodetr_torch.utils.misc import create_logger, is_main_process, set_random_seed  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description="MonoDETR (PyTorch) monocular 3D detection")
    parser.add_argument("--config", dest="config", required=True, help="settings in yaml format")
    parser.add_argument("-e", "--evaluate_only", action="store_true",
                        help="evaluate model on validation set")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    if not os.path.exists(args.config):
        raise FileNotFoundError(args.config)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    cfg = load_config(args.config)
    dp = None
    # as tools/train_val.py:51-56: explicit, or automatic with more than one
    # process; a process not started by a launcher (no RANK) runs alone
    if cfg["trainer"].get("data_parallel", int(os.environ.get("WORLD_SIZE", "1")) > 1) \
            and "RANK" in os.environ:
        init_distributed(device)
        device = rank_device(device)
        dp = DataParallel()
    try:
        run(args, cfg, device, dp)
    finally:
        if dp is not None:
            torch.distributed.destroy_process_group()


def run(args, cfg, device, dp):
    seed = cfg.get("random_seed", 444)
    set_random_seed(seed)
    rank = dp.rank if dp else 0

    model_name = cfg["model_name"]
    output_path = os.path.join("./" + cfg["trainer"].get("save_path", "outputs/"), model_name)
    os.makedirs(output_path, exist_ok=True)
    logger = create_logger(os.path.join(output_path, "%s.log.%s" % (
        "eval" if args.evaluate_only else "train",
        datetime.datetime.now().strftime("%Y%m%d_%H%M%S"))), rank=rank)
    logger.info("device: %s" % (torch.cuda.get_device_name(device) if device.type == "cuda"
                                else device.type))
    if dp is not None:
        logger.info("data parallel: %d ranks" % dp.world)

    train_loader, test_loader = build_dataloader(
        cfg["dataset"], process_shard=(dp.rank, dp.world) if dp else None)
    dtype = compute_dtype(cfg["model"])
    model = build_monodetr(cfg["model"], seed=seed)
    logger.info("model params: %.2fM" % (sum(p.numel() for p in model.parameters()) / 1e6))

    model = model.to(device)  # f32 parameters; the forward runs in `dtype` under autocast
    tester = Tester(cfg=cfg["tester"], model=model, dataloader=test_loader, logger=logger,
                    train_cfg=cfg["trainer"], model_name=model_name, device=device)
    if args.evaluate_only:
        if not is_main_process():  # rank 0 evaluates
            return
        logger.info("###################  Evaluation Only  ##################")
        with torch.autocast(device.type, dtype=dtype, enabled=dtype != torch.float32):
            tester.test()
        return

    trainer = Trainer(
        cfg=cfg["trainer"], model=model, criterion=SetCriterion(cfg["model"]),
        train_loader=train_loader, lr_cfg=cfg["lr_scheduler"],
        optim_cfg=cfg["optimizer"], logger=logger, model_name=model_name,
        tester=tester if cfg["dataset"]["test_split"] != "test" else None,
        device=device, compute_dtype=dtype, seed=seed, dp=dp)

    logger.info("###################  Training  ##################")
    logger.info("Batch Size: %d" % (cfg["dataset"]["batch_size"]))
    logger.info("Learning Rate: %f" % (cfg["optimizer"]["lr"]))
    trainer.train()

    if cfg["dataset"]["test_split"] == "test" or not is_main_process():
        return
    logger.info("###################  Evaluation  ##################")
    with torch.autocast(device.type, dtype=dtype, enabled=dtype != torch.float32):
        tester.test()


if __name__ == "__main__":
    main()
