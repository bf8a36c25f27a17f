"""Evaluation orchestration (monodetr_tpu/eval/tester.py): the checkpoint
to evaluate, batched no-grad inference with per-image timing, top-k
extraction on the device, host decode to KITTI txt files, and the official
KITTI AP evaluation of those files.

Checkpoints are the JAX package's format (train/checkpoint.py: a pickle of
numpy pytrees, `model_state` holding the flax params); they load through
convert.params_from_jax.  The AP evaluator is the port's copy of the JAX
package's pure-numpy KITTI evaluator (eval/kitti_eval/), imported at the
first evaluation.  Under data parallel only rank 0 writes result txts
and evaluates (monodetr_tpu/eval/tester.py:142-153).
"""

import os
import pickle
import time

import numpy as np
import torch

from ..convert import params_from_jax
from ..data.kitti_utils import Calibration
from ..utils.misc import is_main_process
from .decode import decode_detections, extract_dets_from_outputs, save_results


def kitti_eval(results_dir, label_dir, idx_list, writelist, logger):
    """Official KITTI AP of the result txts against the labels, as
    monodetr_tpu/data/kitti_dataset.py:KITTIDataset.eval (:115-136) does it;
    returns the Car moderate AP3D_R40 (0 when Car is not evaluated)."""
    from .kitti_eval import eval as ev, kitti_common as kitti

    logger.info("==> Loading detections and GTs...")
    dt_annos = kitti.get_label_annos(results_dir)
    gt_annos = kitti.get_label_annos(label_dir, [int(i) for i in idx_list])
    test_id = {"Car": 0, "Pedestrian": 1, "Cyclist": 2}
    logger.info("==> Evaluating (official) ...")
    car_moderate = 0
    for category in writelist:
        if category not in test_id:
            continue
        results_str, _, map3d_r40 = ev.get_official_eval_result(
            gt_annos, dt_annos, test_id[category])
        if category == "Car":
            car_moderate = map3d_r40
        logger.info(results_str)
    return car_moderate


def load_checkpoint(filename, logger=None):
    """A JAX-package checkpoint dict; its `model_state` is a flax tree.
    Unpickles, so open only checkpoints this project wrote."""
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    if logger:
        logger.info("==> Loading from checkpoint '{}'".format(filename))
    with open(filename, "rb") as f:
        return pickle.load(f)


class Tester:
    def __init__(self, cfg, model, dataloader, logger, train_cfg=None,
                 model_name="monodetr", device="cuda"):
        """`model` is a monodetr_torch MonoDETR already on `device` in its
        compute dtype."""
        self.cfg = cfg
        self.model = model
        self.dataloader = dataloader
        self.logger = logger
        self.train_cfg = train_cfg or {}
        self.device = torch.device(device)
        self.output_dir = os.path.join(
            "./" + self.train_cfg.get("save_path", "outputs/"), model_name)

    def checkpoint_path(self):
        """The single-mode checkpoint (tester_helper.py:30-43)."""
        if self.cfg.get("checkpoint_path"):
            return self.cfg["checkpoint_path"]
        if self.train_cfg.get("save_all", False):
            return os.path.join(self.output_dir, "checkpoint_epoch_{}.pth".format(
                self.cfg.get("checkpoint", 0)))
        path = os.path.join(self.output_dir, "checkpoint_best.pth")
        fallback = os.path.join(self.output_dir, "checkpoint.pth")
        if not os.path.exists(path) and os.path.exists(fallback):
            self.logger.info("checkpoint_best.pth missing; using %s" % fallback)
            return fallback
        return path

    def load(self, path):
        state = load_checkpoint(path, self.logger)
        sd = params_from_jax(state["model_state"])
        dtype = next(self.model.parameters()).dtype
        self.model.load_state_dict({k: v.to(self.device, dtype) for k, v in sd.items()})

    def epoch_checkpoints(self):
        """Mode `all`: every checkpoint_epoch_N.pth under the output
        directory with N >= the config's `checkpoint`, oldest file first
        (tester.py:83-93)."""
        start_epoch = int(self.cfg.get("checkpoint", 0))
        found = []
        for _, _, files in os.walk(self.output_dir):
            for f in files:
                if (f.startswith("checkpoint_epoch_") and f.endswith(".pth")
                        and f[17:-4].isdigit() and int(f[17:-4]) >= start_epoch):
                    found.append(os.path.join(self.output_dir, f))
        found.sort(key=os.path.getmtime)
        return found

    def test(self):
        """Mode `single`, or `all` when the trainer does not keep every
        epoch (`save_all`): load the checkpoint if one is on disk, else keep
        the model's weights; write the KITTI txts and evaluate them.  Mode
        `all` with `save_all`: the same for each of `epoch_checkpoints()`
        (tester.py:48-98).  Returns the last decoded results (None when
        `all` finds no checkpoint)."""
        mode = self.cfg.get("mode", "single")
        if mode not in ("single", "all"):
            raise ValueError(f"tester mode {mode!r}; expected 'single' or 'all'")
        results = None
        if mode == "single" or not self.train_cfg.get("save_all", False):
            path = self.checkpoint_path()
            if os.path.exists(path):
                self.load(path)
            else:
                self.logger.info("no checkpoint on disk (%s); evaluating in-memory "
                                 "weights" % path)
            results = self.inference()
            self.evaluate()
        else:
            for path in self.epoch_checkpoints():
                self.load(path)
                results = self.inference()
                self.evaluate()
        return results

    @torch.no_grad()
    def predict(self, images, calibs, img_sizes):
        """numpy batch -> [B, topk, 37] numpy detections."""
        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        out = self.model(dev(images), dev(calibs), dev(img_sizes))
        dets = extract_dets_from_outputs(out, topk=self.cfg.get("topk", 50))
        return dets.cpu().numpy()

    def inference(self):
        self.model.eval()
        results = {}
        model_times = []
        for batch, infos in self.dataloader:
            t0 = time.time()
            dets = self.predict(batch["images"], batch["calibs"], batch["img_sizes"])
            model_times.append((time.time() - t0) / len(infos))

            n_valid = len(infos)
            info = {"img_id": [i["img_id"] for i in infos],
                    "img_size": [i["img_size"] for i in infos]}
            calibs = [Calibration.from_p2(batch["calibs"][i]) for i in range(n_valid)]
            results.update(decode_detections(
                dets[:n_valid], info, calibs, self.dataloader.dataset.cls_mean_size,
                self.cfg.get("threshold", 0.2)))

        if model_times:
            self.ms_per_img = 1000 * float(np.mean(model_times[1:] or model_times))
            self.logger.info("inference on %d images, %.1f ms/img (model)"
                             % (len(results), self.ms_per_img))
        self.save_results(results)
        return results

    @property
    def results_dir(self):
        return os.path.join(self.output_dir, "outputs", "data")

    def save_results(self, results):
        if is_main_process():  # one writer under data parallel
            save_results(results, self.results_dir)

    def evaluate(self):
        """Car moderate AP3D_R40 of the txts that `inference` wrote, against
        the loader's dataset labels (its label_dir, idx_list, writelist);
        0 on a rank other than 0."""
        if not is_main_process():
            return 0.0
        if not os.path.exists(self.results_dir):
            raise FileNotFoundError(self.results_dir)
        ds = self.dataloader.dataset
        return kitti_eval(self.results_dir, ds.label_dir, ds.idx_list, ds.writelist,
                          self.logger)
