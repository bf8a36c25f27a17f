"""Box format conversions used by decode (monodetr_tpu/ops/box_ops.py)."""

import torch


def box_cxcylrtb_to_xyxy(x):
    """(cx, cy, l, r, t, b) -> corner xyxy (reference utils/box_ops.py:20-24)."""
    xc, yc, l, r, t, b = x.unbind(-1)
    return torch.stack([xc - l, yc - t, xc + r, yc + b], dim=-1)


def box_xyxy_to_cxcywh(x):
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)
