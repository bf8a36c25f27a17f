"""Box format conversions and (generalized) IoU (monodetr_tpu/ops/box_ops.py,
reference utils/box_ops.py:13-72), with arbitrary leading batch dims."""

import torch


def box_cxcywh_to_xyxy(x):
    xc, yc, w, h = x.unbind(-1)
    return torch.stack([xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h], dim=-1)


def box_cxcylrtb_to_xyxy(x):
    """(cx, cy, l, r, t, b) -> corner xyxy (reference utils/box_ops.py:20-24)."""
    xc, yc, l, r, t, b = x.unbind(-1)
    return torch.stack([xc - l, yc - t, xc + r, yc + b], dim=-1)


def box_xyxy_to_cxcywh(x):
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou_pairwise(boxes1, boxes2):
    """boxes1 [..., N, 4] x boxes2 [..., M, 4] -> ([..., N, M] iou, union)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union, union


def generalized_box_iou(boxes1, boxes2):
    """Pairwise GIoU [..., N, M] of xyxy boxes; degenerate boxes flow
    through (callers mask padded entries)."""
    iou, union = box_iou_pairwise(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area


def generalized_box_iou_elementwise(boxes1, boxes2):
    """GIoU of matched pairs: [..., 4] x [..., 4] -> [...]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / union
    lt_e = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_e = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_e = (rb_e - lt_e).clamp(min=0)
    area = wh_e[..., 0] * wh_e[..., 1]
    return iou - (area - union) / area
