"""Standalone loss library (counterpart of monodetr_tpu/ops/losses.py, the
reference's lib/losses/): the seven losses as torch functions with
optional element masks, so that they compose with the padded [B, T]
target layout (a masked mean over padded slots equals the reference's
mean over ragged concatenations).  The criterion (models/criterion.py)
takes its focal, dimension-aware and Laplacian terms from here.

Reference citations:
  - sigmoid_focal_loss:                 lib/losses/focal_loss.py:69-94
  - heatmap focal (RetinaNet-style):    lib/losses/focal_loss.py:6-34
  - cornernet focal:                    lib/losses/focal_loss.py:37-66
  - dim_aware_l1_loss:                  lib/losses/dim_aware_loss.py:4-14
  - laplacian/gaussian aleatoric:       lib/losses/uncertainty_loss.py:5-24
"""

import torch


def _weighted(x, mask):
    """x with the (broadcast) mask applied: zero where it is False or 0.  A
    bool mask selects, so that an inf or NaN in a masked slot stays out;
    a numeric mask weights."""
    if mask.dtype == torch.bool:
        return torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return x * mask.to(x.dtype)


def _masked_mean(x, mask):
    if mask is None:
        return x.mean()
    count = torch.broadcast_to(mask, x.shape).to(x.dtype).sum()
    return _weighted(x, mask).sum() / count.clamp(min=1.0)


def sigmoid_focal_loss(logits, targets, num_boxes, alpha=0.25, gamma=2.0, query_mask=None):
    """RetinaNet focal loss on logits: mean over the class axis, summed over
    queries, / num_boxes (focal_loss.py:69-94).  logits/targets [..., Q, C];
    query_mask [..., Q] optional (1 = count).  The numerically stable
    BCE-with-logits form."""
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    loss = loss.mean(-1)  # mean over classes
    if query_mask is not None:
        loss = _weighted(loss, query_mask)
    if isinstance(num_boxes, torch.Tensor):
        return loss.sum() / num_boxes.clamp(min=1.0)
    return loss.sum() / max(float(num_boxes), 1.0)


def heatmap_focal_loss(probs, target, alpha=0.25, gamma=2.0):
    """Dense heatmap focal loss on probabilities (focal_loss.py:6-34):
    positives where target == 1, the rest negatives; -(pos + neg) / the
    positives' count, or -neg when there is no positive."""
    pos = (target == 1.0).to(probs.dtype)
    neg = (target < 1.0).to(probs.dtype)
    eps = 1e-12
    pos_loss = torch.log(probs.clamp(min=eps)) * (1 - probs) ** gamma * pos * alpha
    neg_loss = torch.log((1 - probs).clamp(min=eps)) * probs ** gamma * neg * (1 - alpha)
    num_pos = pos.sum()
    total = pos_loss.sum() + neg_loss.sum()
    return torch.where(num_pos == 0, -neg_loss.sum(), -total / num_pos.clamp(min=1.0))


def cornernet_focal_loss(probs, target, gamma=2.0):
    """CornerNet's penalty-reduced focal loss (focal_loss.py:37-66): the
    negatives weighted by (1 - target)^4, so cells near a peak cost less."""
    pos = (target == 1.0).to(probs.dtype)
    neg = (target < 1.0).to(probs.dtype)
    eps = 1e-12
    pos_loss = torch.log(probs.clamp(min=eps)) * (1 - probs) ** gamma * pos
    neg_loss = torch.log((1 - probs).clamp(min=eps)) * probs ** gamma * neg * (1 - target) ** 4
    num_pos = pos.sum()
    total = pos_loss.sum() + neg_loss.sum()
    return torch.where(num_pos == 0, -neg_loss.sum(), -total / num_pos.clamp(min=1.0))


def dim_aware_l1_loss(pred, target, dimension, mask=None, reduction="mean", dp=None):
    """L1 divided by the (detached) target dimension, times a no-grad
    compensation weight that gives it plain L1's magnitude
    (dim_aware_loss.py:4-14): the masked mean, or with reduction "sum" the
    masked sum.  With data parallel (`dp`, parallel/ddp.py) the weight and
    the mean's count are over all ranks' elements (each rank returns its
    share of the global batch's loss)."""
    dimension = dimension.detach()
    abs_err = (pred - target).abs()
    loss = abs_err / dimension
    if mask is None:
        mask = torch.ones((), dtype=torch.bool, device=pred.device)
    count = torch.broadcast_to(mask, loss.shape).to(loss.dtype).sum()
    sums = torch.stack([count, _weighted(abs_err, mask).sum(),
                        _weighted(loss, mask).sum()]).detach()
    if dp is not None:
        sums = dp.sum(sums)
    n = sums[0].clamp(min=1.0)
    compensation = (sums[1] / n) / (sums[2] / n).clamp(min=1e-12)
    total = _weighted(loss * compensation, mask).sum()
    return total if reduction == "sum" else total / n


def laplacian_aleatoric_uncertainty_loss(pred, target, log_variance, reduction="mean",
                                         mask=None):
    """sqrt(2) e^{-s} |x - x*| + s (uncertainty_loss.py:5-14)."""
    loss = 1.4142 * torch.exp(-log_variance) * (pred - target).abs() + log_variance
    if reduction == "sum":
        return (loss if mask is None else _weighted(loss, mask)).sum()
    return _masked_mean(loss, mask)


def gaussian_aleatoric_uncertainty_loss(pred, target, log_variance, reduction="mean",
                                        mask=None):
    """0.5 e^{-s} |x - x*|^2 + 0.5 s (uncertainty_loss.py:16-24)."""
    loss = 0.5 * torch.exp(-log_variance) * (pred - target).abs() ** 2 + 0.5 * log_variance
    if reduction == "sum":
        return (loss if mask is None else _weighted(loss, mask)).sum()
    return _masked_mean(loss, mask)
