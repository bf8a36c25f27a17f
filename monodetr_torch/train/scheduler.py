"""Learning-rate schedule: per-epoch step decay with an optional 5-epoch
cosine warm-up.  A copy of monodetr_tpu/train/scheduler.py:20-46 (importing
monodetr_tpu.train would import jax): the reference's semantics
(scheduler_helper.py:6-18, trainer_helper.py:80-83), the LR a pure function
of the epoch."""

import math


def lr_at_epoch(cfg_lr, base_lr, epoch, max_epoch=195):
    """The LR used during epoch `epoch` (0-based): the schedulers step after
    each epoch, so epoch 0 runs at base_lr (or warm-up(0) = 1e-5).
    `type: 'cos'` is cosine annealing base_lr -> 0 over max_epoch."""
    warmup = cfg_lr.get("warmup", False)
    if warmup and epoch < 5:
        init_lr = 0.00001
        return init_lr + (base_lr - init_lr) * (1 - math.cos(math.pi * epoch / 5)) / 2

    if cfg_lr.get("type", "step") == "cos":
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / max_epoch))

    decay = 1.0
    for step in cfg_lr.get("decay_list", []):
        if epoch >= step:
            decay *= cfg_lr.get("decay_rate", 0.1)
    return base_lr * decay
