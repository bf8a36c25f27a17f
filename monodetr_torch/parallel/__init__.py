"""Data parallel over torch.distributed (counterpart of
monodetr_tpu/parallel/)."""
