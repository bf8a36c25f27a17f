"""The reference's training steps and its eval forward, on a state dict and
inputs that the benchmark hands to it.

Both take the configuration's reference module (`arch`: reference/model.py
or another that the configuration names), whose `build` makes the model
and `trained` tells the leaves the optimizer updates.

`train_steps` takes AdamW steps on the given batches from the given
weights, with the dropout masks of a generator seeded as the program's,
and returns per step the total loss, the first step's gradient norm of
every trained leaf, and each leaf's change after the last step.  A model
that picks proposals (its forward returns them) takes the program's
picks, where given, and returns every token's proposal score besides.  A
batch too large for the card at float32 is computed in micro-batches: a
first pass without gradients matches every layer and sums the dimension
loss's compensation weight over the whole batch, a second takes the
gradients.

`candidates` returns, per image, every (query, class) pair of the last
decoder layer in the 37 columns of a detection, and `decode` turns one
detection row into a KITTI row.
"""

import math

import numpy as np
import torch

from . import loss as L
from .drops import Drops
from .model import f32

TARGET_KEYS = ("labels", "boxes", "boxes_3d", "depth", "size_3d", "heading_bin",
               "heading_res", "mask")


def _cut(batch, b0, b1):
    return {k: v[b0:b1] for k, v in batch.items()}


def _given(given, lid, b0, b1):
    """Layer lid's (b, q, t) of the images b0 .. b1 - 1, b counted from b0."""
    if given is None:
        return None
    b, q, t = given[lid]
    sel = (b >= b0) & (b < b1)
    return b[sel] - b0, q[sel], t[sel]


def step_grads(arch, model, m, batch, gen, micro, given=None, given_picks=None):
    """(total loss, {name: gradient}, excess, assignment, loss terms,
    proposals) of one training step.  given: per decoder layer the (b, q,
    t) assignment to train with (another solver's), whose excess cost over
    this step's optimum is returned; None to match here.  The assignment
    trained with is returned in the same form.  given_picks: the proposal
    picks [B, K] to take (the program's), or None for the model's own; a
    set that does not cover the batch is not taken.  proposals: None for a
    model that picks none, else (the picks taken [B, K], every token's
    score [B, S]), on the host."""
    B = batch["images"].shape[0]
    if given_picks is not None and given_picks.shape[0] != B:
        given_picks = None
    drops = Drops(gen, m["dropout"], B, batch["images"].device) if gen is not None else None
    tgt = {k: batch[k] for k in TARGET_KEYS}
    num_boxes = (tgt["mask"].sum().float() * m["group_num"]).clamp(min=1.0)
    chunks = [(b0, min(B, b0 + micro)) for b0 in range(0, B, micro)]
    w = {k: float(m[k]) for k in ("set_cost_class", "set_cost_bbox", "set_cost_giou",
                                  "set_cost_3dcenter")}
    matches, comp, excess = {}, None, 0.0

    def forward(mb, b0, b1):
        picks = {} if given_picks is None else {
            "proposal_idx": given_picks[b0:b1].to(mb["images"].device)}
        return model(mb["images"], mb["calibs"], mb["img_sizes"], True,
                     drops and drops.start(b0, b1), **picks)

    def matched(out, t_mb, b0, b1, lid):
        nonlocal excess
        if (b0, lid) not in matches:
            idx, ex = L.match(out["pred_logits"], out["pred_boxes"], t_mb, m["group_num"], w,
                              _given(given, lid, b0, b1))
            matches[b0, lid] = idx
            excess = max(excess, ex)
        return matches[b0, lid]

    if len(chunks) > 1:
        sums = 0
        with torch.no_grad():
            for b0, b1 in chunks:
                mb = _cut(batch, b0, b1)
                t_mb = _cut(tgt, b0, b1)
                outs = forward(mb, b0, b1)[0]
                per = []
                for lid, out in enumerate(outs):
                    b, q, t = (i.to(out["pred_3d_dim"].device)
                               for i in matched(out, t_mb, b0, b1, lid))
                    size = t_mb["size_3d"][b, t]
                    abs_err = (out["pred_3d_dim"][b, q] - size).abs()
                    per.append(L.dim_sums(abs_err, abs_err / size))
                sums = sums + torch.stack(per)
                del outs
        comp = sums[:, 0] / sums[:, 1].clamp(min=1e-12)
    for p in model.parameters():
        p.grad = None
    total, terms, props = 0.0, {}, []
    for b0, b1 in chunks:
        mb = _cut(batch, b0, b1)
        t_mb = _cut(tgt, b0, b1)
        outs, depth_logits, picked = forward(mb, b0, b1)
        if picked is not None:
            props.append((picked["idx"].cpu(), picked["scores"].cpu()))
        losses = {}
        for lid, out in enumerate(outs):
            per = L.layer_losses(out, t_mb, matched(out, t_mb, b0, b1, lid), num_boxes,
                                 None if comp is None else comp[lid])
            suffix = "" if lid == len(outs) - 1 else f"_{lid}"
            losses.update({k + suffix: v for k, v in per.items()})
        losses["loss_depth_map"] = L.depth_map_loss(depth_logits, t_mb, m, B)
        loss = L.total(losses, m)
        loss.backward()
        total += float(loss.detach())
        for k, v in losses.items():
            terms[k] = terms.get(k, 0.0) + float(v.detach())
        del outs, depth_logits, losses, loss
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters() if arch.trained(n)}
    used = [tuple(torch.cat([matches[b0, lid][k] + (b0 if k == 0 else 0) for b0, _ in chunks])
                  for k in range(3)) for lid in range(m["dec_layers"])]
    proposals = tuple(torch.cat(t) for t in zip(*props)) if props else None
    return total, grads, excess, used, terms, proposals


def train_steps(arch, model_cfg, state, batches, drop_seed, lr, weight_decay, micro, device,
                prec=f32, given=None, given_picks=None):
    """Steps over `batches` (dicts of tensors on `device`) from `state`;
    given: per step, the assignment of every layer to train with (see
    step_grads), or None; given_picks: per step, the proposal picks to
    take, or None.  Returns {"losses" [n], "grad" (the first step's
    gradient norm of every trained leaf), "change" (each leaf's change after
    the last step), "excess" (per step, the largest of the given assignments'
    excess cost per target), "terms" (per step, each loss term), "assignment"
    (per step, what was trained with)}, and for a model that picks
    proposals "picks" and "proposal_scores" (per step, the picks taken and
    every token's score)."""
    m = dict(model_cfg)
    m.setdefault("group_num", 11)
    model = arch.build(m, device)
    model.load_state_dict(state)
    model.set_precision(prec)
    for n, p in model.named_parameters():
        p.requires_grad_(arch.trained(n))
    named = [(n, p) for n, p in model.named_parameters() if arch.trained(n)]
    start = {n: p.detach().clone() for n, p in named}
    opt = L.AdamW(named, lr, weight_decay)
    gen = torch.Generator(device).manual_seed(drop_seed) if m["dropout"] > 0 else None
    out = {"losses": [], "terms": [], "excess": [], "assignment": []}
    for i, batch in enumerate(batches):
        total, grads, excess, used, terms, proposals = step_grads(
            arch, model, m, batch, gen, micro, None if given is None else given[i],
            None if given_picks is None else given_picks[i])
        if proposals is not None:
            out.setdefault("picks", []).append(proposals[0])
            out.setdefault("proposal_scores", []).append(proposals[1])
        out["losses"].append(total)
        out["terms"].append(terms)
        out["assignment"].append(used)
        out["excess"].append(excess)
        if i == 0:
            out["grad"] = {n: float(g.double().norm()) for n, g in grads.items()}
        opt.step(grads)
        del grads
    out["change"] = {n: float((p.detach() - start[n]).double().norm()) for n, p in named}
    return out


def assignment(matched_q, mask):
    """The program's matcher output [layers, B, groups, T] (query index of
    each image, group and target slot; padded slots masked by mask [B, T])
    -> per layer (b, q, t) int64 tensors of the valid slots."""
    L_, B, G, T = matched_q.shape
    b, t = torch.nonzero(mask.cpu(), as_tuple=True)
    out = []
    for lid in range(L_):
        q = matched_q[lid].cpu()[b, :, t]  # [n, G]
        out.append((b.repeat_interleave(G), q.reshape(-1), t.repeat_interleave(G)))
    return out


@torch.no_grad()
def candidates(arch, model_cfg, state, images, calibs, img_sizes, device, block=16, prec=f32):
    """[N, Q * C, 37] float64 numpy: every (query, class) of the last layer,
    index q * C + c, in a detection's columns: label, score, x2d, y2d, w2d,
    h2d, depth, 24 heading, 3 size, x3d, y3d, exp(-sigma)."""
    model = arch.build(model_cfg, device)
    model.load_state_dict(state)
    model.set_precision(prec)
    rows = []
    for b0 in range(0, images.shape[0], block):
        sl = slice(b0, b0 + block)
        out = model(images[sl].to(device), calibs[sl].to(device),
                    img_sizes[sl].to(device))[0][-1]
        B, Q, C = out["pred_logits"].shape
        box = out["pred_boxes"]
        x1, y1 = box[..., 0] - box[..., 2], box[..., 1] - box[..., 4]
        x2, y2 = box[..., 0] + box[..., 3], box[..., 1] + box[..., 5]
        per_q = torch.cat([
            torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1),
            out["pred_depth"][..., 0:1], out["pred_angle"], out["pred_3d_dim"],
            box[..., 0:2], torch.exp(-out["pred_depth"][..., 1:2])], -1)  # [B, Q, 35]
        label = torch.arange(C, device=device, dtype=torch.float32)[None, None, :, None]
        score = torch.sigmoid(out["pred_logits"])[..., None]
        cand = torch.cat([label.expand(B, Q, C, 1), score,
                          per_q[:, :, None, :].expand(B, Q, C, 35)], -1)
        rows.append(cand.reshape(B, Q * C, 37).double().cpu().numpy())
    return np.concatenate(rows)


def heading_angle(h):
    b = int(np.argmax(h[:12]))
    a = b * (2 * np.pi / 12) + float(h[12 + b])
    return a - 2 * np.pi if a > np.pi else a


def wrap(a):
    a = np.where(a > np.pi, a - 2 * np.pi, a)
    return np.where(a < -np.pi, a + 2 * np.pi, a)


def decode(det, p2, img_size, mean_size):
    """One detection row -> [cls, alpha, x1, y1, x2, y2, h, w, l, X, Y, Z,
    ry, score] with the camera matrix p2 [3, 4] and the image's (w, h)."""
    p2 = np.asarray(p2, np.float64)
    cu, cv, fu, fv = p2[0, 2], p2[1, 2], p2[0, 0], p2[1, 1]
    tx, ty = p2[0, 3] / -fu, p2[1, 3] / -fv
    cls = int(det[0])
    x, y = det[2] * img_size[0], det[3] * img_size[1]
    w, h = det[4] * img_size[0], det[5] * img_size[1]
    depth = det[6]
    dims = det[31:34] + mean_size[cls]
    u, v = det[34] * img_size[0], det[35] * img_size[1]
    X = (u - cu) * depth / fu + tx
    Y = (v - cv) * depth / fv + ty + dims[0] / 2
    alpha = heading_angle(det[7:31])
    ry = float(wrap(alpha + math.atan2(x - cu, fu)))
    return [cls, alpha, x - w / 2, y - h / 2, x + w / 2, y + h / 2, *dims.tolist(),
            X, Y, depth, ry, det[1] * det[-1]]
