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
"""

import numpy as np
import torch

TARGET_KEYS = ("labels", "boxes", "boxes_3d", "depth", "size_3d", "heading_bin",
               "heading_res", "mask")
BATCH_KEYS = ("images", "calibs", "img_sizes") + TARGET_KEYS


def batch_to_device(batch, device):
    """The loader's numpy batch as tensors on `device` (mask as bool)."""
    out = {}
    for k in BATCH_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        out[k] = t.to(device, torch.bool if k == "mask" else None)
    return out


def make_train_step(model, criterion, optimizer, compute_dtype=torch.float32, dp=None):
    """Returns train_step(batch, lr, gen) -> LossVector.

    batch: tensors on the model's device (batch_to_device; with `dp` this
    rank's slice); lr: a float; gen: the torch.Generator on that device
    that every dropout draws from (None: no dropout)."""
    loss_keys = []
    autocast = compute_dtype != torch.float32

    def train_step(batch, lr, gen=None):
        model.train()
        device = batch["images"].device
        with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
            out = model(batch["images"], batch["calibs"], batch["img_sizes"], train=True,
                        gen=gen)
        losses = criterion(out, {k: batch[k] for k in TARGET_KEYS}, train=True, dp=dp)
        total = criterion.total(losses)
        optimizer.zero_grad()
        total.backward()
        if dp is not None:
            dp.sum_grads(optimizer.params)
        optimizer.step(lr)
        keys = sorted(losses)
        if not loss_keys:
            loss_keys.extend(keys + ["loss_detr"])
        stacked = torch.stack([losses[k].detach().float() for k in keys] + [total.detach()])
        return LossVector(tuple(loss_keys), stacked if dp is None else dp.sum(stacked))

    return train_step


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
