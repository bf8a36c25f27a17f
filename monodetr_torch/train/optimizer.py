"""Optimizers with the reference's semantics (monodetr_tpu/train/optimizer.py,
reference lib/helpers/optimizer_helper.py:18-129).

The reference AdamW is not torch.optim.AdamW: its decoupled weight decay is
scaled by the bias-corrected step size,

    p -= lr * sqrt(1 - b2^t) / (1 - b1^t) * (wd * p + m / (sqrt(v) + eps)),

with raw (not bias-corrected) moments m, v kept in f32.  Weight decay
applies to every parameter whose last name component is not `bias`
(`in_proj_bias` does decay, as in the JAX package).  The frozen stem and
layer1 of the backbone (requires_grad=False) and the FrozenBN buffers are
not parameters the optimizer sees, so they never move.  `adam` is the same
rule without decay; `sgd` is momentum 0.9 with L2 decay.

A step has a host part and a device part.  `step(lr)` counts the step and
writes lr into a tensor on the parameters' device when it changed; the
update (`update()`) then reads only device memory: the learning rate, the
AdamW step counter (a float32 tensor, so its step size is computed on the
device in f32, as the JAX step does), the gradients and the state.  The
update is a segment (utils/segments.py), which a training step may replay
as a CUDA graph: it then reads each gradient at the address the training
step's graphs keep for it (train/train_step.py:StepGraphs).
"""

import torch

from ..utils.segments import segment

FROZEN_PREFIXES = ("backbone.0.body.conv1.", "backbone.0.body.layer1.")


def is_frozen(name):
    """The reference's freezing policy by parameter name (backbone.py:71-73)."""
    return name.startswith(FROZEN_PREFIXES)


def wants_decay(name):
    return name.rsplit(".", 1)[-1] != "bias"


class Optimizer:
    """Shared state of the three rules: the trained parameters by name,
    their decay flags, and a step count."""

    def __init__(self, named_params, weight_decay=0.0001):
        self.names, self.params = [], []
        for name, p in named_params:
            if p.requires_grad and not is_frozen(name):
                self.names.append(name)
                self.params.append(p)
        self.decays = [wants_decay(n) for n in self.names]
        self.weight_decay = float(weight_decay)
        self.step_count = 0
        device = self.params[0].device if self.params else None
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self._lr = None  # the host value in self.lr

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self, lr):
        """One update at learning rate lr."""
        self.step_count += 1
        if lr != self._lr:
            self.lr.fill_(lr)
            self._lr = lr
        segment(None, self.update)

    def _grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]


class RefAdamW(Optimizer):
    """The reference AdamW; `adam` is the same with weight_decay 0."""

    def __init__(self, named_params, weight_decay=0.0001, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(named_params, weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.v = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.t = torch.zeros((), dtype=torch.float32, device=self.lr.device)  # the step count

    def step_size(self):
        """lr * sqrt(1 - b2^t) / (1 - b1^t) at the device's step count t, in
        f32 on the device."""
        return self.lr * torch.sqrt(1 - self.b2 ** self.t) / (1 - self.b1 ** self.t)

    @torch.no_grad()
    def update(self):
        grads = [g.float() for g in self._grads()]
        # b1 m + (1 - b1) g in one pass, so that the update makes as many
        # passes as with a host step size
        torch._foreach_lerp_(self.m, grads, 1 - self.b1)
        torch._foreach_mul_(self.v, self.b2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1 - self.b2)
        self.t.add_(1.0)
        denom = torch._foreach_sqrt(self.v)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.m, denom)
        if self.weight_decay:
            dec = [p for p, d in zip(self.params, self.decays) if d]
            upd_dec = [u for u, d in zip(upd, self.decays) if d]
            torch._foreach_add_(upd_dec, dec, alpha=self.weight_decay)
        torch._foreach_mul_(upd, self.step_size())
        torch._foreach_sub_(self.params, upd)

    def state_dict(self):
        return {"step": self.step_count, "m": dict(zip(self.names, self.m)),
                "v": dict(zip(self.names, self.v))}

    def load_state_dict(self, state):
        self.step_count = int(state["step"])
        self.t.fill_(self.step_count)
        for i, n in enumerate(self.names):
            self.m[i].copy_(state["m"][n])
            self.v[i].copy_(state["v"][n])


class SGD(Optimizer):
    """Momentum 0.9 with L2 weight decay on the decayed parameters
    (optimizer.py:132-151)."""

    def __init__(self, named_params, weight_decay=0.0001):
        super().__init__(named_params, weight_decay)
        self.m = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def update(self):
        torch._foreach_mul_(self.m, 0.9)
        torch._foreach_add_(self.m, [g.float() for g in self._grads()])
        if self.weight_decay:
            torch._foreach_add_([m for m, d in zip(self.m, self.decays) if d],
                                [p for p, d in zip(self.params, self.decays) if d],
                                alpha=self.weight_decay)
        torch._foreach_sub_(self.params, torch._foreach_mul(self.m, self.lr))

    def state_dict(self):
        return {"step": self.step_count, "m": dict(zip(self.names, self.m))}

    def load_state_dict(self, state):
        self.step_count = int(state["step"])
        for i, n in enumerate(self.names):
            self.m[i].copy_(state["m"][n])


def build_optimizer(cfg_optimizer, model):
    """The config's optimizer (`type`: adamw | adam | sgd) over the model's
    trained parameters (optimizer_helper.build_optimizer)."""
    kind = cfg_optimizer.get("type", "adamw")
    wd = float(cfg_optimizer.get("weight_decay", 0.0001))
    params = model.named_parameters()
    if kind == "adamw":
        return RefAdamW(params, wd)
    if kind == "adam":
        return RefAdamW(params, 0.0)
    if kind == "sgd":
        return SGD(params, wd)
    raise NotImplementedError(f"{kind} optimizer is not supported")
