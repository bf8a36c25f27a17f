"""Sine position table (monodetr_tpu/models/position_encoding.py:17).

Inputs have fixed shapes and all-valid masks, so the reference's
cumsum-over-not-mask reduces to a static table built in numpy."""

import torch

from ..ops.utils import device_constant, sine_position_encoding


def sine_pos_table(h, w, hidden_dim, device="cpu"):
    """[h, w, hidden_dim] static sine position table (normalize=True), f32."""
    return device_constant(sine_position_encoding, (h, w, hidden_dim // 2), torch.device(device))
