"""Hungarian matching on the device (monodetr_tpu/models/matcher.py:156-275,
reference matcher.py:62-104).

The cost of every (query, target) pair per image and group is the
reference's: focal class cost, L1 3-D centre, L1 l/r/t/b extents and GIoU,
weighted 2/10/5/2; non-finite costs and invalid targets cost BIG_COST.
Targets are sorted valid-first so that the solver's skipped rows are the
padding, and every (layer, image, group) problem of a step is solved in
one call of ops/lap.py:lap_solve (the CUDA kernel on the card): the JAX
package vmaps the layers for the same effect (criterion.py:294-298).
Matching runs without gradients, as the reference's does.
"""

import torch

from ..ops import box_ops
from ..ops.lap import lap_solve

BIG_COST = 1e6


def matching_cost(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
                  cost_class=2.0, cost_3dcenter=10.0, cost_bbox=5.0,
                  cost_giou=2.0, focal_alpha=0.25, focal_gamma=2.0):
    """Cost [..., Q, T] for pred_logits [..., Q, C], pred_boxes [..., Q, 6]
    and targets tgt_labels [..., T], tgt_boxes [..., T, 6], tgt_valid
    [..., T] whose leading dims broadcast."""
    prob = torch.sigmoid(pred_logits)
    neg = (1 - focal_alpha) * prob ** focal_gamma * (-torch.log(1 - prob + 1e-8))
    pos = focal_alpha * (1 - prob) ** focal_gamma * (-torch.log(prob + 1e-8))
    Q, C = pred_logits.shape[-2:]
    T = tgt_labels.shape[-1]
    lead = torch.broadcast_shapes(pred_logits.shape[:-2], tgt_labels.shape[:-1])
    idx = tgt_labels.long().expand(*lead, T)[..., None, :].expand(*lead, Q, T)
    cls_cost = torch.gather((pos - neg).expand(*lead, Q, C), -1, idx)  # [..., Q, T]

    center_cost = (pred_boxes[..., :, None, :2] - tgt_boxes[..., None, :, :2]).abs().sum(-1)
    bbox_cost = (pred_boxes[..., :, None, 2:6] - tgt_boxes[..., None, :, 2:6]).abs().sum(-1)
    giou_cost = -box_ops.generalized_box_iou(
        box_ops.box_cxcylrtb_to_xyxy(pred_boxes), box_ops.box_cxcylrtb_to_xyxy(tgt_boxes))
    cost = (cost_bbox * bbox_cost + cost_3dcenter * center_cost
            + cost_class * cls_cost + cost_giou * giou_cost)
    # a non-finite cost would break the augmenting-path search: a bad
    # forward gives a degraded match, never a hang
    big = torch.full_like(cost, BIG_COST)
    return torch.where(torch.isfinite(cost) & tgt_valid[..., None, :], cost, big)


@torch.no_grad()
def hungarian_match(pred_logits, pred_boxes, targets, group_num=11,
                    cost_class=2.0, cost_3dcenter=10.0, cost_bbox=5.0, cost_giou=2.0):
    """pred_logits [..., B, G*nq, C], pred_boxes [..., B, G*nq, 6] (any
    leading dims, e.g. the decoder layers); targets: labels [B, T],
    boxes_3d [B, T, 6], mask [B, T] bool.

    Returns matched_q [..., B, G, T] int64: for each (image, group, target
    slot) the index of the assigned query in [0, G*nq).  Slots of invalid
    targets point at query 0 of their own group and must be masked with
    targets['mask']."""
    *lead, B, QG, C = pred_logits.shape
    if QG % group_num:
        # the JAX matcher fails here with a reshape error
        raise ValueError(
            f"hungarian_match: {QG} queries do not split into group_num={group_num} "
            "groups; two_stage trains its num_queries proposals as one group, so it "
            "trains with group_num: 1")
    nq = QG // group_num
    mask = targets["mask"].bool()
    T = mask.shape[1]
    if T > nq:
        raise ValueError(f"hungarian_match: {T} target slots > {nq} queries per group")

    # valid targets first (stable), so the solver's skipped rows are the
    # padding and its loops stop at the real object count
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)  # [B, T]
    labels = torch.gather(targets["labels"].long(), 1, order)
    tboxes = torch.gather(targets["boxes_3d"].float(), 1, order[..., None].expand(-1, -1, 6))
    valid = torch.gather(mask, 1, order)

    logits = pred_logits.float().reshape(*lead, B, group_num, nq, C)
    boxes = pred_boxes.float().reshape(*lead, B, group_num, nq, 6)
    cost = matching_cost(
        logits, boxes, labels[:, None].expand(B, group_num, T),
        tboxes[:, None].expand(B, group_num, T, 6), valid[:, None].expand(B, group_num, T),
        cost_class, cost_3dcenter, cost_bbox, cost_giou)  # [..., B, G, nq, T]
    # rows = targets padded to nq, columns = queries
    cost_tq = cost.transpose(-1, -2)
    row_valid = valid[:, None].expand(*lead, B, group_num, T)
    if nq > T:
        pad = cost_tq.new_full((*cost_tq.shape[:-2], nq - T, nq), BIG_COST)
        cost_tq = torch.cat([cost_tq, pad], -2)
        row_valid = torch.cat([row_valid, row_valid.new_zeros(*row_valid.shape[:-1], nq - T)],
                              -1)
    matched_s = lap_solve(cost_tq.contiguous(), row_valid.contiguous())[..., :T].long()

    # undo the sort: slot order[b, i] was solved as row i
    inv = torch.argsort(order, dim=1)
    matched = torch.gather(matched_s, -1, inv[:, None].expand(matched_s.shape))
    matched = matched.clamp(min=0)  # unsolved (invalid) slots -> query 0
    offsets = torch.arange(group_num, device=matched.device)[:, None] * nq
    return matched + offsets
