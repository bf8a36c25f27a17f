"""DN-DETR denoising queries (counterpart of monodetr_tpu/models/dn.py,
reference lib/models/monodetr/dn_components.py).

As in the reference and the JAX package, defined but not wired in:
`MonoDETR.forward` never calls `prepare_for_dn` (the reference imports it
at monodetr.py:21 and never calls it, and passes no attention mask to the
transformer, monodetr.py:203-204), and `use_dn` is False in the shipped
config.  The same functional surface exists for a custom trainer.

Fixed shapes, as in the JAX package: every denoising group is padded to
the targets' T slots with a validity mask (the reference pads to the
batch's largest object count, dn_components.py:140); padded slots carry
zero queries and count in no reconstruction loss.  The noise is drawn from
an explicit torch.Generator by `prepare_for_dn`; `dn_queries` is the same
construction from given draws, so that a test can feed it the draws
jax.random makes for the JAX function.
"""

import torch
import torch.nn.functional as F

from ..ops import box_ops
from ..ops.utils import inverse_sigmoid


def prepare_for_dn(gen, targets, label_embed_table, scalar=5, label_noise_scale=0.2,
                   box_noise_scale=0.4, num_classes=3):
    """Noised denoising queries from padded targets (dn_components.py:
    99-155).  targets: labels [B, T], boxes_3d [B, T, 6], mask [B, T] and
    the 3-D keys (size_3d, depth, heading_bin, heading_res);
    label_embed_table [num_classes + 1, hidden_dim - 1] (the reference's
    label_enc, monodetr.py:52); gen: a torch.Generator on the table's
    device.  Draws, in this order: the label-flip uniforms [B, S, T], the
    random labels [B, S, T] in [0, num_classes), the box uniforms [B, S, T,
    6].  Returns dn_queries(...)."""
    B, T = targets["labels"].shape
    shape = (B, scalar, T)
    device = label_embed_table.device
    flip_u = torch.rand(shape, generator=gen, device=device)
    rand_labels = torch.randint(0, num_classes, shape, generator=gen, device=device)
    box_u = torch.rand(shape + (6,), generator=gen, device=device)
    return dn_queries(targets, label_embed_table, flip_u, rand_labels, box_u,
                      label_noise_scale, box_noise_scale)


def dn_queries(targets, label_embed_table, flip_u, rand_labels, box_u, label_noise_scale=0.2,
               box_noise_scale=0.4):
    """prepare_for_dn from its draws (flip_u, rand_labels [B, S, T], box_u
    [B, S, T, 6]; S, the group count, is their second dim): labels
    flipped to the random label where flip_u < label_noise_scale
    (dn_components.py:115-121), boxes jittered by (2 box_u - 1) times the
    box's extent times box_noise_scale and clipped to [0, 1] (:123-132),
    the flipped labels' embeddings with an indicator 1 appended (:134-138).
    Returns (label queries [B, S*T, hidden_dim], reference boxes before
    the sigmoid [B, S*T, 6], the attention mask [S*T, S*T] bool (True =
    blocked), mask_dict)."""
    B, S, T = flip_u.shape
    labels = targets["labels"][:, None, :].expand(B, S, T)
    boxes = targets["boxes_3d"][:, None].expand(B, S, T, 6)
    valid = targets["mask"][:, None, :].expand(B, S, T)

    noised_labels = torch.where(flip_u < label_noise_scale, rand_labels.to(labels.dtype), labels)
    diff = torch.stack([(boxes[..., 2] + boxes[..., 3]) / 2, (boxes[..., 4] + boxes[..., 5]) / 2,
                        boxes[..., 2], boxes[..., 3], boxes[..., 4], boxes[..., 5]], -1)
    jitter = (box_u * 2 - 1.0) * diff * box_noise_scale
    noised_boxes = (boxes + jitter).clamp(0.0, 1.0)

    emb = label_embed_table[noised_labels.long()]  # [B, S, T, hidden - 1]
    label_queries = torch.cat([emb, torch.ones_like(emb[..., :1])], -1)
    label_queries = torch.where(valid[..., None], label_queries, 0.0)
    ref_unact = torch.where(valid[..., None], inverse_sigmoid(noised_boxes), 0.0)

    pad_size = S * T

    def known(x, width):
        return x[:, None].expand(B, S, T, width).reshape(B, pad_size, width)

    mask_dict = {
        "pad_size": pad_size,
        "scalar": S,
        "known_labels": labels.reshape(B, pad_size),
        "known_boxes": boxes.reshape(B, pad_size, 6),
        "known_valid": valid.reshape(B, pad_size),
        "known_size_3d": known(targets["size_3d"], 3),
        "known_depth": known(targets["depth"], 1),
        "known_heading_bin": known(targets["heading_bin"], 1),
        "known_heading_res": known(targets["heading_res"], 1),
    }
    return (label_queries.reshape(B, pad_size, -1), ref_unact.reshape(B, pad_size, 6),
            dn_attn_mask(pad_size, T, 0, label_queries.device), mask_dict)


def dn_attn_mask(pad_size, single_pad, num_match_queries, device=None):
    """[Stot, Stot] bool, True = attention BLOCKED (dn_components.py:
    157-170): the matching queries cannot see the denoising queries, and a
    denoising group cannot see another."""
    tot = pad_size + num_match_queries
    mask = torch.zeros((tot, tot), dtype=torch.bool, device=device)
    if pad_size > 0:
        mask[pad_size:, :pad_size] = True
        group = torch.arange(pad_size, device=device) // single_pad
        mask[:pad_size, :pad_size] = group[:, None] != group[None, :]
    return mask


def dn_post_process(outputs_class, outputs_coord, outputs_3d_dim, outputs_depth,
                    outputs_angle, mask_dict):
    """Split the decoder outputs ([L, B, Q, .] stacks) into the denoising
    part, stored in mask_dict["output_known_lbs_bboxes"], and the matching
    part, returned (dn_components.py:188-206)."""
    outs = (outputs_class, outputs_coord, outputs_3d_dim, outputs_depth, outputs_angle)
    if mask_dict and mask_dict["pad_size"] > 0:
        p = mask_dict["pad_size"]
        mask_dict["output_known_lbs_bboxes"] = tuple(o[:, :, :p] for o in outs)
        return tuple(o[:, :, p:] for o in outs)
    return outs


def _masked_sum(x, valid):
    return torch.where(valid, x, 0.0).sum()


def compute_dn_loss(mask_dict, training, aux_num, focal_alpha=0.25):
    """Reconstruction losses of the denoising queries (dn_components.py:
    335-392): focal labels, L1 and GIoU boxes, L1 centre, bin CE plus
    residual angles; the aux layers repeat them with the suffix _i.  Zeros
    outside training or without denoising outputs."""
    losses = {}
    if not (training and mask_dict and "output_known_lbs_bboxes" in mask_dict):
        zero = torch.zeros((), dtype=torch.float32)
        base = {k: zero for k in ("tgt_loss_bbox", "tgt_loss_giou", "tgt_loss_ce",
                                  "tgt_loss_center", "tgt_loss_angle")}
        losses.update(base)
        for i in range(aux_num):
            losses.update({f"{k}_{i}": v for k, v in base.items()})
        return losses

    out_class, out_coord, _, _, out_angle = mask_dict["output_known_lbs_bboxes"]
    labels = mask_dict["known_labels"].long()
    boxes = mask_dict["known_boxes"]
    valid = mask_dict["known_valid"]
    hbin = mask_dict["known_heading_bin"][..., 0].long()
    hres = mask_dict["known_heading_res"][..., 0]
    num_tgt = valid.sum().float().clamp(min=1.0)

    def layer_losses(cls_l, coord_l, angle_l):
        out = {}
        # focal labels over the denoising queries (tgt_loss_labels, :310-332)
        C = cls_l.shape[-1]
        onehot = F.one_hot(torch.where(valid, labels, C), C + 1)[..., :C].to(cls_l.dtype)
        prob = torch.sigmoid(cls_l)
        ce = cls_l.clamp(min=0) - cls_l * onehot + torch.log1p(torch.exp(-cls_l.abs()))
        p_t = prob * onehot + (1 - prob) * (1 - onehot)
        fl = ce * (1 - p_t) ** 2 * (focal_alpha * onehot + (1 - focal_alpha) * (1 - onehot))
        out["tgt_loss_ce"] = torch.where(valid[..., None], fl, 0.0).sum() / num_tgt
        out["tgt_loss_bbox"] = _masked_sum(
            (coord_l[..., 2:6] - boxes[..., 2:6]).abs(), valid[..., None]) / num_tgt
        giou = box_ops.generalized_box_iou_elementwise(
            box_ops.box_cxcylrtb_to_xyxy(coord_l), box_ops.box_cxcylrtb_to_xyxy(boxes))
        out["tgt_loss_giou"] = _masked_sum(1 - giou, valid) / num_tgt
        out["tgt_loss_center"] = _masked_sum(
            (coord_l[..., :2] - boxes[..., :2]).abs(), valid[..., None]) / num_tgt
        logp = torch.log_softmax(angle_l[..., :12], -1)
        cls_loss = -torch.gather(logp, -1, hbin[..., None])[..., 0]
        res_pred = torch.gather(angle_l[..., 12:24], -1, hbin[..., None])[..., 0]
        out["tgt_loss_angle"] = _masked_sum(cls_loss + (res_pred - hres).abs(), valid) / num_tgt
        return out

    losses.update(layer_losses(out_class[-1], out_coord[-1], out_angle[-1]))
    for i in range(aux_num):
        li = layer_losses(out_class[i], out_coord[i], out_angle[i])
        losses.update({f"{k}_{i}": v for k, v in li.items()})
    return losses
