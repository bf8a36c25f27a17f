"""Training: the reference AdamW, the LR schedule, the train step,
checkpoints and the epoch loop (counterpart of monodetr_tpu/train/)."""

from .optimizer import build_optimizer
from .scheduler import lr_at_epoch
from .train_step import make_eval_step, make_train_step

__all__ = ["build_optimizer", "lr_at_epoch", "make_train_step", "make_eval_step"]
