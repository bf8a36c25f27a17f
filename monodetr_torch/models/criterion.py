"""SetCriterion: Hungarian-matched training losses on the device
(monodetr_tpu/models/criterion.py, reference monodetr.py:296-532 and
depth_predictor/ddn_loss/).

Targets stay padded to [B, T] with a validity mask; every loss is a masked
dense reduction.  The 8 terms: labels (focal), cardinality (log only),
centre, boxes (L1 + GIoU), depths (Laplacian aleatoric), dims
(compensated relative L1), angles (bin CE + residual L1), depth map (DDN
focal over the min-depth rasterisation of the 2-D boxes).  The aux losses
repeat all but the depth map for each earlier decoder layer; all layers are
matched in one solver call.

Data parallel (parallel/ddp.py): given the run's `dp` (its rank count
`world` and `sum`, a sum over ranks), every term a rank returns is its
share of the loss of the global batch, so that the shares of all ranks sum
to the single-process loss on the whole batch: the box count and the
dimension loss's compensation weight are sums over ranks, the depth-map
loss and the cardinality error (means over images) are divided by the rank
count.  The matching stays per image, on the rank's own targets.
"""

import torch

from ..ops import box_ops
from ..ops.utils import bin_depths
from .matcher import hungarian_match

LAYER_KEYS = ("pred_logits", "pred_boxes", "pred_3d_dim", "pred_depth", "pred_angle")


def _gather_queries(pred, matched_q):
    """pred [B, QG, ...] at matched_q [B, G, T] -> [B, G, T, ...]."""
    B, G, T = matched_q.shape
    flat = matched_q.reshape(B, G * T)
    idx = flat.reshape(B, G * T, *([1] * (pred.dim() - 2))).expand(B, G * T, *pred.shape[2:])
    return torch.gather(pred, 1, idx).reshape(B, G, T, *pred.shape[2:])


def loss_labels(outputs, targets, matched_q, num_boxes, focal_alpha=0.25):
    """Sigmoid focal classification loss (monodetr.py:320-345)."""
    logits = outputs["pred_logits"]
    B, QG, C = logits.shape
    _, G, T = matched_q.shape
    labels = targets["labels"].long()[:, None, :].expand(B, G, T)
    valid = targets["mask"][:, None, :].expand(B, G, T)
    # scatter the matched labels into a dense [B, QG] class map (C =
    # no object); invalid slots go to a dropped extra column
    idx = torch.where(valid, matched_q, QG).reshape(B, -1)
    target_classes = torch.full((B, QG + 1), C, dtype=torch.long, device=logits.device)
    target_classes.scatter_(1, idx, labels.reshape(B, -1))
    classes = torch.arange(C, device=logits.device)
    onehot = (target_classes[:, :QG, None] == classes).to(logits.dtype)  # no-object: 0
    prob = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
    p_t = prob * onehot + (1 - prob) * (1 - onehot)
    loss = ce * (1 - p_t) ** 2
    alpha_t = focal_alpha * onehot + (1 - focal_alpha) * (1 - onehot)
    return {"loss_ce": (alpha_t * loss).sum() / num_boxes}


@torch.no_grad()
def loss_cardinality(outputs, targets, world=1):
    """Log only: |#argmax != last class - #targets| (monodetr.py:347-359),
    the mean over images (a rank's share of it: / world)."""
    logits = outputs["pred_logits"]
    card_pred = (logits.argmax(-1) != logits.shape[-1] - 1).sum(-1)
    err = (card_pred.float() - targets["mask"].sum(-1).float()).abs()
    return {"cardinality_error": err.mean() / world}


def loss_center(outputs, targets, matched_q, num_boxes):
    src = _gather_queries(outputs["pred_boxes"], matched_q)[..., :2]
    tgt = targets["boxes_3d"][:, None, :, :2]
    valid = targets["mask"][:, None, :, None]
    l1 = torch.where(valid, (src - tgt).abs(), 0.0)
    return {"loss_center": l1.sum() / num_boxes}


def loss_boxes(outputs, targets, matched_q, num_boxes):
    src = _gather_queries(outputs["pred_boxes"], matched_q)  # [B, G, T, 6]
    tgt = targets["boxes_3d"][:, None].expand_as(src)
    valid = targets["mask"][:, None, :]
    l1 = torch.where(valid[..., None], (src[..., 2:6] - tgt[..., 2:6]).abs(), 0.0)
    giou = box_ops.generalized_box_iou_elementwise(
        box_ops.box_cxcylrtb_to_xyxy(src), box_ops.box_cxcylrtb_to_xyxy(tgt))
    loss_giou = torch.where(valid, 1.0 - giou, 0.0)
    return {"loss_bbox": l1.sum() / num_boxes, "loss_giou": loss_giou.sum() / num_boxes}


def loss_depths(outputs, targets, matched_q, num_boxes):
    """Laplacian aleatoric depth loss (monodetr.py:393-404)."""
    src = _gather_queries(outputs["pred_depth"], matched_q)
    d, logvar = src[..., 0], src[..., 1]
    tgt = targets["depth"][:, None, :, 0]
    valid = targets["mask"][:, None, :]
    loss = 1.4142 * torch.exp(-logvar) * (d - tgt).abs() + logvar
    return {"loss_depth": torch.where(valid, loss, 0.0).sum() / num_boxes}


def loss_dims(outputs, targets, matched_q, num_boxes, dp=None):
    """Size-normalised L1 with a no-grad compensation weight
    (monodetr.py:406-420), a ratio of sums over the batch (over all ranks
    with `dp`)."""
    src = _gather_queries(outputs["pred_3d_dim"], matched_q)  # [B, G, T, 3]
    tgt = targets["size_3d"][:, None, :, :]
    valid = targets["mask"][:, None, :, None]
    abs_err = (src - tgt).abs()
    # padded target sizes are 0: divide by 1 there, so masked entries put
    # no inf into the backward (0 * inf = NaN)
    safe_tgt = torch.where(valid, tgt.expand_as(src), 1.0).detach()
    dim_loss = abs_err / safe_tgt
    sums = torch.stack([valid.sum() * 3.0, torch.where(valid, abs_err, 0.0).sum(),
                        torch.where(valid, dim_loss, 0.0).sum()]).detach()
    if dp is not None:
        sums = dp.sum(sums)
    n = sums[0].clamp(min=1.0)
    comp = (sums[1] / n) / (sums[2] / n)
    return {"loss_dim": torch.where(valid, dim_loss * comp, 0.0).sum() / num_boxes}


def loss_angles(outputs, targets, matched_q, num_boxes):
    """12-bin CE + residual L1 of the target bin (monodetr.py:422-446)."""
    src = _gather_queries(outputs["pred_angle"], matched_q)  # [B, G, T, 24]
    bins = targets["heading_bin"][:, None, :, 0].long().expand(src.shape[:3])
    res = targets["heading_res"][:, None, :, 0].expand(src.shape[:3])
    valid = targets["mask"][:, None, :]
    logp = torch.log_softmax(src[..., :12], -1)
    cls_loss = -torch.gather(logp, -1, bins[..., None])[..., 0]
    res_pred = torch.gather(src[..., 12:24], -1, bins[..., None])[..., 0]
    loss = torch.where(valid, cls_loss + (res_pred - res).abs(), 0.0)
    return {"loss_angle": loss.sum() / num_boxes}


def loss_depth_map(outputs, targets, fg_weight=13.0, bg_weight=1.0, alpha=0.25, gamma=2.0,
                   depth_min=1e-3, depth_max=60.0, num_bins=80, raster_wh=None,
                   bin_mode="LID", world=1):
    """DDN depth-map loss (ddn_loss.py + balancer.py + focalloss.py).

    Each pixel's target is the depth of the nearest valid box covering it
    (the reference paints boxes far to near, criterion.py:156-212), binned;
    focal CE, foreground weighted 13x, normalised by the pixel count.
    `raster_wh` (W, H) scales the normalised boxes; None uses the map's
    own size.  world: the rank count of data parallel (the rank's share of
    the mean over the global batch)."""
    logits = outputs["pred_depth_map_logits"]  # [B, H, W, bins + 1]
    B, Hf, Wf, _ = logits.shape
    valid = targets["mask"]
    depth = targets["depth"][..., 0]
    rw, rh = (Wf, Hf) if raster_wh is None else raster_wh
    bx = targets["boxes"]
    xyxy = box_ops.box_cxcywh_to_xyxy(torch.stack(
        [bx[..., 0] * rw, bx[..., 1] * rh, bx[..., 2] * rw, bx[..., 3] * rh], -1))
    u1, v1 = torch.floor(xyxy[..., 0]), torch.floor(xyxy[..., 1])
    u2, v2 = torch.ceil(xyxy[..., 2]), torch.ceil(xyxy[..., 3])
    ys = torch.arange(Hf, dtype=torch.float32, device=logits.device)[None, None, :, None]
    xs = torch.arange(Wf, dtype=torch.float32, device=logits.device)[None, None, None, :]
    cover = ((xs >= u1[..., None, None]) & (xs < u2[..., None, None])
             & (ys >= v1[..., None, None]) & (ys < v2[..., None, None])
             & valid[..., None, None])  # [B, T, H, W]
    cand = torch.where(cover, depth[..., None, None], 1e9)
    fg_mask = cover.any(1)
    pix_depth = torch.where(fg_mask, cand.min(1).values, 0.0)
    tgt_bin = bin_depths(pix_depth, bin_mode, depth_min, depth_max, num_bins)

    logp = torch.log_softmax(logits, -1)
    logp_t = torch.gather(logp, -1, tgt_bin[..., None])[..., 0]
    p_t = torch.exp(logp_t)
    focal = -alpha * (1.0 - p_t) ** gamma * logp_t
    weights = torch.where(fg_mask, fg_weight, bg_weight)
    return {"loss_depth_map": (focal * weights).sum() / (B * Hf * Wf) / world}


class SetCriterion:
    """Loss aggregator with the reference's weights.

        crit = SetCriterion(cfg_model)
        losses = crit(outputs, targets, train=True)
        total = crit.total(losses)

    `targets`: tensors on the outputs' device, padded to [B, T]: labels,
    boxes (cxcywh, normalised), boxes_3d (cxcylrtb), depth [B, T, 1],
    size_3d, heading_bin [B, T, 1], heading_res [B, T, 1], mask (bool).
    `dp`: None, or data parallel's reduction (parallel/ddp.py:DataParallel:
    `world`, and `sum(tensor)` over ranks); the losses are then this
    rank's shares (module docstring)."""

    def __init__(self, cfg):
        self.num_classes = cfg.get("num_classes", 3)
        self.focal_alpha = cfg.get("focal_alpha", 0.25)
        self.dec_layers = cfg.get("dec_layers", 3)
        self.group_num = cfg.get("group_num", 11)
        self.cost_class = float(cfg.get("set_cost_class", 2))
        self.cost_3dcenter = float(cfg.get("set_cost_3dcenter", 10))
        self.cost_bbox = float(cfg.get("set_cost_bbox", 5))
        self.cost_giou = float(cfg.get("set_cost_giou", 2))
        self.depth_min = float(cfg.get("depth_min", 1e-3))
        self.depth_max = float(cfg.get("depth_max", 60.0))
        self.num_depth_bins = int(cfg.get("num_depth_bins", 80))
        self.depth_map_raster_wh = cfg.get("depth_map_raster_wh")
        self.depth_bin_mode = cfg.get("depth_bin_mode", cfg.get("mode", "LID"))
        base = {
            "loss_ce": cfg.get("cls_loss_coef", 2),
            "loss_bbox": cfg.get("bbox_loss_coef", 5),
            "loss_giou": cfg.get("giou_loss_coef", 2),
            "loss_dim": cfg.get("dim_loss_coef", 1),
            "loss_angle": cfg.get("angle_loss_coef", 1),
            "loss_depth": cfg.get("depth_loss_coef", 1),
            "loss_center": cfg.get("3dcenter_loss_coef", 10),
            "loss_depth_map": cfg.get("depth_map_loss_coef", 1),
        }
        weight_dict = dict(base)
        for i in range(self.dec_layers - 1):
            weight_dict.update({f"{k}_{i}": v for k, v in base.items()})
        self.weight_dict = weight_dict

    def match(self, outputs, targets, train=True):
        """matched_q [L, B, G, T] for the aux layers then the final one."""
        aux = outputs.get("aux_outputs", [])
        logits = torch.stack([a["pred_logits"] for a in aux] + [outputs["pred_logits"]])
        boxes = torch.stack([a["pred_boxes"] for a in aux] + [outputs["pred_boxes"]])
        return hungarian_match(logits, boxes, targets, self.group_num if train else 1,
                               self.cost_class, self.cost_3dcenter, self.cost_bbox,
                               self.cost_giou)

    def _single(self, outputs, targets, matched_q, num_boxes, dp=None):
        losses = {}
        losses.update(loss_labels(outputs, targets, matched_q, num_boxes, self.focal_alpha))
        losses.update(loss_center(outputs, targets, matched_q, num_boxes))
        losses.update(loss_boxes(outputs, targets, matched_q, num_boxes))
        losses.update(loss_depths(outputs, targets, matched_q, num_boxes))
        losses.update(loss_dims(outputs, targets, matched_q, num_boxes, dp))
        losses.update(loss_angles(outputs, targets, matched_q, num_boxes))
        return losses

    def __call__(self, outputs, targets, train=True, dp=None):
        group_num = self.group_num if train else 1
        world = 1 if dp is None else dp.world
        n_targets = targets["mask"].sum().float()
        if dp is not None:
            n_targets = dp.sum(n_targets)
        num_boxes = (n_targets * group_num).clamp(min=1.0)
        aux = outputs.get("aux_outputs", [])
        matched = self.match(outputs, targets, train)
        losses = {}
        for i, layer in enumerate(aux + [outputs]):
            per = self._single({k: layer[k] for k in LAYER_KEYS}, targets, matched[i], num_boxes,
                               dp)
            suffix = "" if i == len(aux) else f"_{i}"
            losses.update({k + suffix: v for k, v in per.items()})
        losses.update(loss_cardinality(outputs, targets, world))
        losses.update(loss_depth_map(
            outputs, targets, depth_min=self.depth_min, depth_max=self.depth_max,
            num_bins=self.num_depth_bins, raster_wh=self.depth_map_raster_wh,
            bin_mode=self.depth_bin_mode, world=world))
        return losses

    def total(self, losses):
        return sum(losses[k] * w for k, w in self.weight_dict.items() if k in losses)
