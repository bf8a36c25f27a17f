"""MonoDETR's training objective and optimizer, plain: Hungarian matching
of every decoder layer's outputs to the targets within each query group
(scipy's exact assignment on float32 costs), the eight losses with the
published weights, and the published AdamW (decay scaled by the
bias-corrected step size; moments f32; no decay on biases).

Targets are padded to [B, T] with a bool `mask`; boxes_3d are (cx, cy, l,
r, t, b) normalised, boxes (cx, cy, w, h), depth [B, T, 1], size_3d,
heading_bin and heading_res [B, T, 1], labels [B, T].
"""

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

BASE_WEIGHTS = {"loss_ce": "cls_loss_coef", "loss_bbox": "bbox_loss_coef",
                "loss_giou": "giou_loss_coef", "loss_dim": "dim_loss_coef",
                "loss_angle": "angle_loss_coef", "loss_depth": "depth_loss_coef",
                "loss_center": "3dcenter_loss_coef", "loss_depth_map": "depth_map_loss_coef"}


def cxcylrtb_to_xyxy(b):
    cx, cy, l, r, t, bo = b.unbind(-1)
    return torch.stack([cx - l, cy - t, cx + r, cy + bo], -1)


def giou(a, b):
    """GIoU of xyxy boxes, elementwise over broadcast leading dims."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    lt2 = torch.minimum(a[..., :2], b[..., :2])
    rb2 = torch.maximum(a[..., 2:], b[..., 2:])
    wh2 = (rb2 - lt2).clamp(min=0)
    hull = wh2[..., 0] * wh2[..., 1]
    return inter / union - (hull - union) / hull


@torch.no_grad()
def match(logits, boxes, tgt, groups, w, given=None):
    """For one decoder layer: (b, query, slot) of every valid target slot
    in every group, as three int64 tensors, and the excess cost.

    With `given` (such a triple, e.g. another solver's assignment) that
    assignment is returned, and the excess is the largest, over the (image,
    group) problems, of its cost above the optimum under these costs, per
    target; without, the optimum is returned and the excess is 0."""
    B, QG, C = logits.shape
    nq = QG // groups
    prob = torch.sigmoid(logits.float())
    neg = 0.75 * prob ** 2 * (-torch.log(1 - prob + 1e-8))
    pos = 0.25 * (1 - prob) ** 2 * (-torch.log(prob + 1e-8))
    cls = pos - neg  # [B, QG, C]
    out_b, out_q, out_t = [], [], []
    excess = 0.0
    if given is not None:
        gb, gq, gt = (g.cpu().numpy() for g in given)
    for b in range(B):
        slots = torch.nonzero(tgt["mask"][b]).flatten()
        if slots.numel() == 0:
            continue
        lab = tgt["labels"][b, slots].long()
        tb = tgt["boxes_3d"][b, slots].float()
        pb = boxes[b].float()
        cost = (w["set_cost_bbox"] * (pb[:, None, 2:6] - tb[None, :, 2:6]).abs().sum(-1)
                + w["set_cost_3dcenter"] * (pb[:, None, :2] - tb[None, :, :2]).abs().sum(-1)
                + w["set_cost_class"] * cls[b][:, lab]
                - w["set_cost_giou"] * giou(cxcylrtb_to_xyxy(pb)[:, None],
                                            cxcylrtb_to_xyxy(tb)[None]))
        cost = torch.where(torch.isfinite(cost), cost, 1e6).cpu().numpy().astype(np.float64)
        slot_np = slots.cpu().numpy()
        column = {int(s): k for k, s in enumerate(slot_np)}
        for g in range(groups):
            c = cost[g * nq:(g + 1) * nq].T  # [targets, queries]
            rows, cols = linear_sum_assignment(c)
            if given is not None:
                sel = (gb == b) & (gq >= g * nq) & (gq < (g + 1) * nq)
                q_g, t_g = gq[sel] - g * nq, gt[sel]
                best = c[rows, cols].sum()
                if (len(t_g) != len(rows) or len(set(q_g.tolist())) != len(q_g)
                        or not set(t_g.tolist()) <= set(column)):
                    excess = np.inf
                    continue
                else:
                    got = sum(c[column[int(t)], q] for q, t in zip(q_g, t_g))
                    excess = max(excess, (got - best) / len(rows))
                rows, cols = np.array([column[int(t)] for t in t_g], int), q_g
            out_b.append(np.full(len(rows), b))
            out_q.append(cols + g * nq)
            out_t.append(slot_np[rows])
    cat = (lambda xs: torch.from_numpy(np.concatenate(xs)).long()) if out_b else \
        (lambda xs: torch.zeros(0, dtype=torch.long))
    return (cat(out_b), cat(out_q), cat(out_t)), float(excess)


def layer_losses(out, tgt, idx, num_boxes, dim_comp=None):
    """The seven per-layer terms.  dim_comp: the dimension loss's
    compensation weight of the whole batch (None: of these images)."""
    b, q, t = (i.to(out["pred_logits"].device) for i in idx)
    logits = out["pred_logits"]
    onehot = torch.zeros_like(logits)
    onehot[b, q, tgt["labels"][b, t].long()] = 1.0
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * onehot + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    focal = (0.25 * onehot + 0.75 * (1 - onehot)) * ce * (1 - p_t) ** 2
    src_box = out["pred_boxes"][b, q]
    tgt_box = tgt["boxes_3d"][b, t]
    losses = {
        "loss_ce": focal.sum() / num_boxes,
        "loss_center": (src_box[:, :2] - tgt_box[:, :2]).abs().sum() / num_boxes,
        "loss_bbox": (src_box[:, 2:] - tgt_box[:, 2:]).abs().sum() / num_boxes,
        "loss_giou": (1 - giou(cxcylrtb_to_xyxy(src_box), cxcylrtb_to_xyxy(tgt_box))).sum()
        / num_boxes,
    }
    dep = out["pred_depth"][b, q]
    err = (dep[:, 0] - tgt["depth"][b, t, 0]).abs()
    losses["loss_depth"] = (1.4142 * torch.exp(-dep[:, 1]) * err + dep[:, 1]).sum() / num_boxes
    size = tgt["size_3d"][b, t]
    abs_err = (out["pred_3d_dim"][b, q] - size).abs()
    rel = abs_err / size
    if dim_comp is None:
        dim_comp = dim_sums(abs_err, rel)
        dim_comp = dim_comp[0] / dim_comp[1].clamp(min=1e-12)
    losses["loss_dim"] = (rel * dim_comp).sum() / num_boxes
    ang = out["pred_angle"][b, q]
    bins = tgt["heading_bin"][b, t, 0].long()
    logp = torch.log_softmax(ang[:, :12], -1)
    cls = -logp.gather(1, bins[:, None])[:, 0]
    res = ang[:, 12:].gather(1, bins[:, None])[:, 0]
    losses["loss_angle"] = (cls + (res - tgt["heading_res"][b, t, 0]).abs()).sum() / num_boxes
    return losses


def dim_sums(abs_err, rel):
    return torch.stack([abs_err.detach().sum(), rel.detach().sum()])


def lid_bins(depth, dmin, dmax, n):
    size = 2 * (dmax - dmin) / (n * (1 + n))
    idx = -0.5 + 0.5 * torch.sqrt(1 + 8 * (depth - dmin) / size)
    bad = (idx < 0) | (idx > n) | ~torch.isfinite(idx)
    return torch.where(bad, torch.full_like(idx, n), idx).long()


def depth_map_loss(logits, tgt, m, batch):
    """DDN focal loss over the depth of the nearest box covering each pixel
    (boxes painted far to near), foreground weighted 13; mean over the
    pixels of the whole batch of `batch` images."""
    B, H, W, _ = logits.shape
    bx = tgt["boxes"]
    cx, cy, w, h = bx[..., 0] * W, bx[..., 1] * H, bx[..., 2] * W, bx[..., 3] * H
    x1, y1 = torch.floor(cx - 0.5 * w), torch.floor(cy - 0.5 * h)
    x2, y2 = torch.ceil(cx + 0.5 * w), torch.ceil(cy + 0.5 * h)
    ys = torch.arange(H, device=logits.device, dtype=torch.float32)[None, None, :, None]
    xs = torch.arange(W, device=logits.device, dtype=torch.float32)[None, None, None, :]
    cover = ((xs >= x1[..., None, None]) & (xs < x2[..., None, None])
             & (ys >= y1[..., None, None]) & (ys < y2[..., None, None])
             & tgt["mask"][..., None, None])
    depth = torch.where(cover, tgt["depth"][..., 0, None, None], 1e9).min(1).values
    fg = cover.any(1)
    pix = torch.where(fg, depth, 0.0)
    target = lid_bins(pix, float(m["depth_min"]), float(m["depth_max"]), m["num_depth_bins"])
    logp = torch.log_softmax(logits, -1).gather(-1, target[..., None])[..., 0]
    focal = -0.25 * (1 - torch.exp(logp)) ** 2 * logp
    return (focal * torch.where(fg, 13.0, 1.0)).sum() / (batch * H * W)


def weights(m):
    """Loss name -> weight; the aux layers' terms carry the suffix _i."""
    base = {k: float(m[v]) for k, v in BASE_WEIGHTS.items()}
    w = dict(base)
    for i in range(m["dec_layers"] - 1):
        w.update({f"{k}_{i}": v for k, v in base.items()})
    return w


def total(losses, m):
    w = weights(m)
    return sum(losses[k] * w[k] for k in losses if k in w)


class AdamW:
    """The published AdamW over named f32 parameters."""

    def __init__(self, named, lr, weight_decay, b1=0.9, b2=0.999, eps=1e-8):
        self.named = named
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps
        self.m = {n: torch.zeros_like(p) for n, p in named}
        self.v = {n: torch.zeros_like(p) for n, p in named}
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        t = torch.tensor(float(self.t))
        size = float(torch.tensor(self.lr) * torch.sqrt(1 - self.b2 ** t) / (1 - self.b1 ** t))
        for n, p in self.named:
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = self.m[n] / (self.v[n].sqrt() + self.eps)
            if n.rsplit(".", 1)[-1] != "bias":
                upd = upd + self.wd * p
            p.sub_(size * upd)
