"""Loader throughput of monodetr_torch: synthetic KITTI PNGs on disk ->
batches/s (the twin of tools/bench_loader.py, with its flags and lines).

Prints one line per worker mode and worker count: the loader alone (PNG
decode, affine warp, target encode, collate).  Then, per worker mode, one
line of the loader at the largest worker count through the port's handoff
into the card (data/device_prefetch.py: pinned host copies and
non-blocking copies on a side stream), consumed by nothing, so the
handoff's cost shows beside the decode's; without a CUDA card that line
says "not measured".

With --trainer-epochs N it measures the trainer instead: the shipped model
(configs/monodetr.yaml, seeded random weights, bf16 compute) trained by
train/trainer.py:Trainer.train_one_epoch over the same split at
--batch-size, one warm-up epoch, then N epochs timed by the host clock
(the epoch ends in a synchronize), then one epoch under torch.profiler
for the card's idle share (1 - the kernels' summed device time / the
epoch's time; the copies to the card are not counted as busy).  Needs a
CUDA card.  It calls only the Trainer's constructor and train_one_epoch,
so a copy of this file placed in another checkout's tools/ measures that
checkout's trainer.

Usage: python tools/bench_loader_torch.py [--batches 20] [--batch-size 16]
           [--workers 2,4,8,12] [--mode thread,process] [--root DIR]
           [--trainer-epochs N]
"""

import argparse
import logging
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
# by file: a `tests` package installed elsewhere would shadow this one
sys.path.insert(1, os.path.join(REPO, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the trainer's loader threads: build_dataloader's, as the CLI trains
TRAINER_WORKERS = 4


def loader_rate(loader, batches, consume=iter):
    """Batches/s of `batches` batches after the first (which warms the
    pool); `consume` wraps the loader (the handoff into the card)."""
    it = consume(loader)
    next(it)
    t0 = time.perf_counter()
    n = 0
    for _ in it:
        n += 1
        if n >= batches:
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def bench_loader(args, ds, DataLoader):
    workers = [int(x) for x in args.workers.split(",")]
    for mode in args.mode.split(","):
        for w in workers:
            loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True,
                                num_workers=w, prefetch=4, worker_mode=mode)
            np.random.seed(0)
            bps = loader_rate(loader, args.batches)
            print(f"mode={mode:8s} workers={w:3d}: {bps:6.2f} batches/s = "
                  f"{bps * args.batch_size:7.1f} img/s", flush=True)
        w = max(workers)
        if not torch.cuda.is_available():
            print(f"mode={mode:8s} workers={w:3d} through the prefetcher into the card: "
                  f"not measured (no CUDA device)", flush=True)
            continue
        from monodetr_torch.data.device_prefetch import DevicePrefetcher

        loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True, num_workers=w,
                            prefetch=4, worker_mode=mode)
        np.random.seed(0)
        bps = loader_rate(loader, args.batches, lambda ld: iter(DevicePrefetcher(ld, "cuda")))
        print(f"mode={mode:8s} workers={w:3d} through the prefetcher into "
              f"{torch.cuda.get_device_name(0)}: {bps:6.2f} batches/s = "
              f"{bps * args.batch_size:7.1f} img/s", flush=True)


def bench_trainer(args, ds, DataLoader):
    if not torch.cuda.is_available():
        raise RuntimeError("--trainer-epochs: needs a CUDA card")
    from monodetr_torch.config import MONODETR_MODEL
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import build_monodetr, compute_dtype
    from monodetr_torch.train.trainer import Trainer

    logger = logging.getLogger("bench_loader_torch")
    logger.setLevel(logging.WARNING)
    loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True,
                        num_workers=TRAINER_WORKERS)
    model = build_monodetr(MONODETR_MODEL, seed=444).cuda()
    trainer = Trainer(
        {"max_epoch": 195}, model, SetCriterion(MONODETR_MODEL), loader,
        {"warmup": False, "decay_list": [125, 165], "decay_rate": 0.1},
        {"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4}, logger, "bench_loader_torch",
        device="cuda", compute_dtype=compute_dtype(MONODETR_MODEL), seed=444)
    n_imgs = len(ds)
    trainer.train_one_epoch(0)  # warm-up: cuBLAS/cuDNN set-up, the kernels' first launches
    rates = []
    for epoch in range(1, 1 + args.trainer_epochs):
        t0 = time.perf_counter()
        trainer.train_one_epoch(epoch)
        rates.append(n_imgs / (time.perf_counter() - t0))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_one_epoch(1 + args.trainer_epochs)
        wall_ms = 1000 * (time.perf_counter() - t0)
    # kernels only: not the copies, nor the profiler ranges of
    # utils/misc.py:component that the profiler mirrors on the device
    busy_ms = sum(e.device_time_total for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "component::"))) / 1000.0
    print(f"trainer on {torch.cuda.get_device_name(0)}: {n_imgs} images an epoch, batch "
          f"{args.batch_size}, {TRAINER_WORKERS} loader threads, bf16; img/s of "
          f"{len(rates)} epochs: " + " ".join(f"{r:.2f}" for r in rates)
          + f"; profiled epoch {wall_ms:.0f} ms, kernels {busy_ms:.0f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--workers", default="2,4,8,12")
    ap.add_argument("--mode", default="thread,process",
                    help="comma list of worker modes to sweep")
    ap.add_argument("--root", default=os.path.join(REPO, "tmp", "kitti_loader_bench"))
    ap.add_argument("--trainer-epochs", type=int, default=0,
                    help="time the trainer over the split for N epochs instead")
    args = ap.parse_args(argv)

    from monodetr_torch import _build
    from monodetr_torch.data.kitti_dataset import KITTIDataset
    from monodetr_torch.data.loader import DataLoader
    from synthetic_kitti import make_synthetic_kitti

    n_imgs = args.batches * args.batch_size
    if not os.path.exists(os.path.join(args.root, "ImageSets", "train.txt")):
        print(f"generating {n_imgs} synthetic KITTI images under {args.root} ...")
        make_synthetic_kitti(args.root, n_train=n_imgs, n_val=4, seed=7, max_cars=8)

    ds = KITTIDataset("train", {"root_dir": args.root, "writelist": ["Car"],
                                "aug_pd": True, "aug_crop": True})
    print(f"host kernels: {_build.build_host().relative_to(REPO)}; dataset: {len(ds)} images; "
          f"host cpus: {os.cpu_count()}")
    if args.trainer_epochs:
        bench_trainer(args, ds, DataLoader)
    else:
        bench_loader(args, ds, DataLoader)


if __name__ == "__main__":
    main()
