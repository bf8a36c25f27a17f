"""Training orchestration (monodetr_tpu/train/trainer.py, reference
lib/helpers/trainer_helper.py): the epoch loop with a per-epoch numpy
reseed (:74), pretrain merge and resume (:44-63), checkpoint saves (latest
or per epoch, and the best by Car-moderate AP3D_R40, :86-108) with the
in-loop Tester, a log line every 30 batches with img/s, and an optional
torch.profiler trace of a few steps.  With data parallel (`dp`,
parallel/ddp.py) every rank runs the loop on its slice of each global
batch, and only rank 0 writes checkpoints and evaluates.
"""

import os
import time

import numpy as np
import torch

from .checkpoint import (get_checkpoint_state, load_checkpoint, load_model_state,
                         load_optimizer_state, merge_params, save_checkpoint, to_jax_tree)
from .optimizer import build_optimizer
from .scheduler import lr_at_epoch
from .train_step import batch_to_device, make_train_step
from ..utils.misc import is_main_process


class Trainer:
    def __init__(self, cfg, model, criterion, train_loader, lr_cfg, optim_cfg,
                 logger, model_name, tester=None, device="cuda",
                 compute_dtype=torch.float32, seed=444, dp=None):
        """`model`: a monodetr_torch MonoDETR with f32 parameters on
        `device`; `compute_dtype`: the forward's dtype (bf16 runs under
        autocast); `seed`: of the dropout generator (seed + rank with
        `dp`); `dp`: None, or the run's parallel/ddp.py:DataParallel, with
        `train_loader` loading this rank's slices."""
        self.cfg = cfg
        self.model = model
        self.train_loader = train_loader
        self.lr_cfg = lr_cfg
        self.base_lr = float(optim_cfg.get("lr", 2e-4))
        self.logger = logger
        self.epoch = 0
        self.best_result = 0.0
        self.best_epoch = 0
        self.output_dir = os.path.join("./" + cfg.get("save_path", "outputs/"), model_name)
        self.tester = tester
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.dp = dp
        self.gen = torch.Generator(device=self.device).manual_seed(
            seed + (dp.rank if dp else 0))

        if cfg.get("pretrain_model"):
            if not os.path.exists(cfg["pretrain_model"]):
                raise FileNotFoundError(cfg["pretrain_model"])
            state = load_checkpoint(cfg["pretrain_model"], self.logger)
            # partial (e.g. backbone-only) checkpoints merge into the init
            load_model_state(model, merge_params(to_jax_tree(model), state["model_state"]))

        self.optimizer = build_optimizer(optim_cfg, model)
        self.train_step = make_train_step(model, criterion, self.optimizer, compute_dtype, dp)

        if cfg.get("resume_model"):
            resume_path = os.path.join(self.output_dir, "checkpoint.pth")
            if not os.path.exists(resume_path):
                raise FileNotFoundError(resume_path)
            state = load_checkpoint(resume_path, self.logger)
            load_model_state(model, state["model_state"])
            load_optimizer_state(self.optimizer, state["optimizer_state"])
            self.epoch = state["epoch"]
            self.best_result = state["best_result"]
            self.best_epoch = state["best_epoch"]
            self.logger.info("Loading Checkpoint... Best Result:{}, Best Epoch:{}".format(
                self.best_result, self.best_epoch))
        if dp is not None:
            dp.broadcast_(model)

    def train(self):
        for epoch in range(self.epoch, self.cfg["max_epoch"]):
            np.random.seed(np.random.get_state()[1][0] + epoch)
            self.train_one_epoch(epoch)
            self.epoch += 1
            if (self.epoch % self.cfg.get("save_frequency", 1)) == 0:
                self._save_and_eval_epoch()
        # rank 0 only: the other ranks skip _save_and_eval_epoch, so
        # best_result and best_epoch mean something on rank 0 alone, and
        # nothing may branch or start a collective on them
        # (monodetr_tpu/train/trainer.py:108-116)
        self.logger.info("Best Result:{}, epoch:{}".format(self.best_result, self.best_epoch))

    def _state(self):
        return get_checkpoint_state(self.model, self.optimizer, self.epoch,
                                    self.best_result, self.best_epoch)

    def _save_and_eval_epoch(self):
        """Checkpoint and in-loop evaluation, on rank 0 only; the other
        ranks go on and wait in the next step's first collective."""
        if not is_main_process():
            return
        os.makedirs(self.output_dir, exist_ok=True)
        name = ("checkpoint_epoch_%d" % self.epoch if self.cfg.get("save_all", False)
                else "checkpoint")
        save_checkpoint(self._state(), os.path.join(self.output_dir, name))
        if self.tester is None:
            return
        self.logger.info("Test Epoch {}".format(self.epoch))
        with torch.autocast(self.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            self.tester.inference()
        cur_result = self.tester.evaluate()
        if cur_result > self.best_result:
            self.best_result, self.best_epoch = cur_result, self.epoch
            save_checkpoint(self._state(), os.path.join(self.output_dir, "checkpoint_best"))
        self.logger.info("Best Result:{}, epoch:{}".format(self.best_result, self.best_epoch))

    def train_one_epoch(self, epoch):
        self.train_loader.set_epoch(epoch)
        lr = lr_at_epoch(self.lr_cfg, self.base_lr, epoch,
                         max_epoch=int(self.cfg.get("max_epoch", 195)))
        t0 = time.time()
        n_imgs = 0
        # global images: this rank's count times the world, since every
        # rank loads an equal slice of each global batch (but an epoch's
        # last, padded batch, whose valid rows may fall unequally)
        world = self.dp.world if self.dp is not None else 1
        # cfg profile_steps: N -> trace batches [2, 2 + N) of the first
        # epoch to <output>/profile
        profile_steps = int(self.cfg.get("profile_steps", 0)) if epoch == 0 else 0
        prof = None
        for batch_idx, (batch, _infos) in enumerate(self.train_loader):
            if profile_steps and batch_idx == 2:
                prof = self._start_profile()
            if prof is not None and batch_idx == 2 + profile_steps:
                self._stop_profile(prof)
                prof = None
            losses = self.train_step(batch_to_device(batch, self.device), lr, self.gen)
            n_imgs += int(batch["valid"].sum())
            if batch_idx % 30 == 0:
                values = {k: float(v) for k, v in losses.items()}  # one copy
                dt = time.time() - t0
                main = {k: v for k, v in values.items()
                        if not any(k.endswith(f"_{i}") for i in range(6))}
                self.logger.info("epoch %d batch %d | loss_detr %.2f | %s | %.1f img/s" % (
                    epoch, batch_idx, values.get("loss_detr", 0.0),
                    ", ".join(f"{k} {v:.2f}" for k, v in sorted(main.items())),
                    world * n_imgs / dt if dt > 0 else 0))
        if prof is not None:
            self._stop_profile(prof)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t0
        self.logger.info("epoch %d done in %.1fs (%.2f img/s)" % (
            epoch, dt, world * n_imgs / max(dt, 1e-9)))

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = os.path.join(self.output_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        self.logger.info("profiler trace written to %s\n%s" % (out, prof.key_averages().table(
            sort_by="self_cuda_time_total" if self.device.type == "cuda" else "self_cpu_time_total",
            row_limit=25)))
