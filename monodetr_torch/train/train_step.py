"""The training step (monodetr_tpu/train/train_step.py:19-82): forward with
train=True -> Hungarian matching -> the 8 losses with aux layers ->
backward through the kernels -> the optimizer's update, in place.

Parameters and optimizer state stay f32; with compute dtype bf16 the
forward runs under torch.autocast, so the convolutions, the linears and
therefore the MSDA and attention kernels receive bf16 tensors, while the
places the JAX model keeps in f32 stay f32.  The step returns one stacked
loss vector in the JAX package's key order (sorted loss names, then
`loss_detr`, the weighted total), so a caller reads the losses from the
card with one copy.  With data parallel (`dp`, parallel/ddp.py) the step
is the JAX SPMD step's (monodetr_tpu/parallel/mesh.py:53-92): each rank
runs its slice of the global batch, its losses are its shares of the
global batch's (models/criterion.py), the gradients and the loss vector are
summed over ranks, and every rank takes the same optimizer step.

Host time (utils/trace.py): a step is the root span `train step`, whose
children are `forward` (the autocast model call, with the model's spans
inside), `criterion` (the matcher inside), `backward` (the call that
returns once the card has the backward's launches queued) and `optimizer`;
zero_grad, data parallel's gradient sum and the loss stacking are the
root's own time.  `batch_to_device` and the eval step (`eval step`: the
eval forward and the top-k) are roots of their own.
"""

import numpy as np
import torch

from ..utils.trace import span

TARGET_KEYS = ("labels", "boxes", "boxes_3d", "depth", "size_3d", "heading_bin",
               "heading_res", "mask")
BATCH_KEYS = ("images", "calibs", "img_sizes") + TARGET_KEYS


def batch_to_device(batch, device, keys=BATCH_KEYS):
    """The loader's numpy batch (its `keys`) as tensors on `device` (mask as
    bool).

    On a CUDA device each array is copied into pinned host memory and from
    there to the card by a copy queued on the current stream, without
    waiting for the card: the host may free or reuse the pinned buffer
    only after that copy ends (the caching host allocator records the
    copy's event).  A buffer that cannot be pinned raises.  On the CPU the
    arrays are taken as they are (a CPU-only build cannot pin)."""
    device = torch.device(device)
    out = {}
    with span("batch_to_device"):
        for k in keys:
            t = torch.from_numpy(np.ascontiguousarray(batch[k], bool if k == "mask" else None))
            if device.type == "cuda":
                out[k] = t.pin_memory().to(device, non_blocking=True)
            else:
                out[k] = t.to(device)
    return out


def make_train_step(model, criterion, optimizer, compute_dtype=torch.float32, dp=None):
    """Returns train_step(batch, lr, gen) -> LossVector.

    batch: tensors on the model's device (batch_to_device; with `dp` this
    rank's slice); lr: a float; gen: the torch.Generator on that device
    that every dropout draws from (None: no dropout)."""
    loss_keys = []
    autocast = compute_dtype != torch.float32

    def train_step(batch, lr, gen=None):
        with span("train step"):
            model.train()
            device = batch["images"].device
            with span("forward"):
                with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
                    out = model(batch["images"], batch["calibs"], batch["img_sizes"],
                                train=True, gen=gen)
            with span("criterion"):
                losses = criterion(out, {k: batch[k] for k in TARGET_KEYS}, train=True, dp=dp)
                total = criterion.total(losses)
            optimizer.zero_grad()
            with span("backward"):
                total.backward()
            if dp is not None:
                dp.sum_grads(optimizer.params)
            with span("optimizer"):
                optimizer.step(lr)
            keys = sorted(losses)
            if not loss_keys:
                loss_keys.extend(keys + ["loss_detr"])
            stacked = torch.stack([losses[k].detach().float() for k in keys] + [total.detach()])
            return LossVector(tuple(loss_keys), stacked if dp is None else dp.sum(stacked))

    return train_step


def make_eval_step(model, topk=50, threshold=0.2):
    """Returns eval_step(images, calibs, img_sizes) -> detections [B, topk,
    37] (eval/decode.py:extract_dets_from_outputs), the eval forward and
    the top-k under no_grad (monodetr_tpu/train/train_step.py:85-97; as
    there, `threshold` is the decode's, applied on the host)."""
    from ..eval.decode import extract_dets_from_outputs

    @torch.no_grad()
    def eval_step(images, calibs, img_sizes):
        with span("eval step"):
            model.eval()
            return extract_dets_from_outputs(model(images, calibs, img_sizes), topk=topk)

    return eval_step


class LossVector:
    """Named view of the stacked loss vector; reading a value copies the
    whole vector to the host once."""

    def __init__(self, keys, values):
        self.keys_ = keys
        self.values = values
        self._host = None

    def _pull(self):
        if self._host is None:
            self._host = self.values.cpu().numpy()
        return self._host

    def items(self):
        host = self._pull()
        return [(k, host[i]) for i, k in enumerate(self.keys_)]

    def as_dict(self):
        return dict(self.items())
