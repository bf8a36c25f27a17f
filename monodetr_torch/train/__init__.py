"""Training: the reference AdamW, the LR schedule, the train step,
checkpoints and the epoch loop (counterpart of monodetr_tpu/train/)."""
