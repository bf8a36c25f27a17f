"""The numbers that decide `correct`, each a gap between what the program
produced on the timed path and what the reference computes from the same
weights and inputs.

Training (the program's first three steps, which set-up drives through the
window's own step call; the reference trains with the program's own
assignment of queries to targets, since a near-tie that bf16 rounding
breaks otherwise swaps targets between queries):
  match_excess       the first step's assignment: the largest, over the
                     (layer, image, group) problems, of its cost under the
                     reference's costs above the reference's optimum, per
                     target;
  loss_gap           the relative gap of the first step's total loss;
  grad_gap_median    the first step's gradient as the optimizer got it (its
                     first moment after one step over 1 - beta1): per leaf,
                     the gap of the norms over the larger of the reference's
                     norm of that leaf and of the median leaf; the median
                     over the leaves;
  update_gap_median  the same of each leaf's change after three steps,
                     leaving out the leaves whose reference gradient is under
                     a thousandth of the median leaf's (Adam moves them by
                     round-off alone);
  update_gap_3rd_leaf  the third largest of those changes' gaps: a fault
                     that reaches three leaves or more (one op in each of the
                     three layers) reads about 1 there, whatever the median.
  pick_excess        only where the program picks proposals (whose picks
                     the reference takes, as it takes the assignment): the
                     first step's picks: for each image and rank r of the
                     program's picks, the reference's r-th best proposal
                     score less its score at the program's r-th pick
                     (floored at 0); the largest.  Picks that near-tied
                     scores swap read about the rounding of the scores, a
                     wrong set or order (the order sets the query groups)
                     on the scale of the scores; picks that do not cover
                     every image, or repeat a token, read inf.
  Reported beside them and not compared (PERF.md says why): the loss, the
  assignment and the picks over all three steps (after the first step's
  update Adam moves leaves whose gradient is round-off by a whole step, so
  the two sides' weights, and with them the scores, part), and the worst
  and third-worst leaves' gradients and the worst leaf's change.
Inference (a sample of the frames served in the window, each frame judged
as a whole; the number is the worst frame's):
  score_gap   the root mean square of the gaps between the frame's sorted
              top-k scores and the reference's;
  det_gap     for each served detection, the reference's (query, class)
              candidate of the same class nearest to it; the root mean
              square, over the frame's detections and their 36 columns,
              of the column gaps |a - b| / (1 + |b|) to it;
  row_gap     the largest gap |a - b| / (1 + |b|) between a served KITTI row
              and the reference's decoding of the served detection it came
              from (the decode is judged on the program's own detections;
              the detections themselves by det_gap), inf where the rows
              served are not the detections scoring the threshold.
"""

import math

import numpy as np


def _norm_gaps(prog, ref, keep=None):
    """{leaf: gap} of per-leaf norms, each gap over the larger of the
    reference's norm of that leaf and of the median leaf (inf for every
    leaf where the two sides' leaves differ)."""
    if set(prog) != set(ref):
        return {n: math.inf for n in set(prog) | set(ref)}
    names = [n for n in ref if keep is None or keep(n)]
    med = float(np.median([ref[n] for n in names]))
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}
    return {n: g if math.isfinite(g) else math.inf for n, g in gaps.items()}


def _ranked(gaps, k):
    """The k-th largest gap (1-based) and its leaf."""
    leaf = sorted(gaps, key=lambda n: -gaps[n])[min(k, len(gaps)) - 1]
    return gaps[leaf], leaf


def pick_excess(picks, scores):
    """picks: the program's proposal picks [B, K] of one step, in its rank
    order; scores: the reference's score of every token [B, S] at that
    step -> that step's pick_excess (see above)."""
    p, s = np.asarray(picks), np.asarray(scores, np.float64)
    if (p.ndim != 2 or p.shape[0] != s.shape[0] or p.shape[1] > s.shape[1]
            or p.min() < 0 or p.max() >= s.shape[1]
            or any(len(np.unique(row)) != len(row) for row in p)):
        return math.inf
    best = -np.sort(-s, axis=1)[:, :p.shape[1]]
    return max(0.0, float(np.max(best - np.take_along_axis(s, p, 1))))


def train_numbers(prog, ref):
    """prog / ref: {"losses": [steps], "grad": {leaf: norm}, "change":
    {leaf: norm}}, ref also "excess" [steps]; where the program picked
    proposals prog "picks" and ref "proposal_scores" [steps] -> ({name:
    value}, {name: worst leaf})."""
    lp, lr_ = np.asarray(prog["losses"], float), np.asarray(ref["losses"], float)
    loss = np.abs(lp - lr_) / np.abs(lr_)
    loss = np.where(np.isfinite(loss), loss, np.inf)
    grad = _norm_gaps(prog["grad"], ref["grad"])
    med = float(np.median(list(ref["grad"].values())))
    update = _norm_gaps(prog["change"], ref["change"],
                        lambda n: n in ref["grad"] and ref["grad"][n] >= 1e-3 * med)
    (g1, g1_leaf), (g3, _) = _ranked(grad, 1), _ranked(grad, 3)
    (u1, u1_leaf), (u3, u3_leaf) = _ranked(update, 1), _ranked(update, 3)
    numbers = {"match_excess": float(ref["excess"][0]), "loss_gap": float(loss[0]),
               "grad_gap_median": float(np.median(list(grad.values()))),
               "update_gap_median": float(np.median(list(update.values()))),
               "update_gap_3rd_leaf": u3,
               "match_excess_any_step": float(max(ref["excess"])),
               "loss_gap_any_step": float(loss.max()), "grad_gap_worst_leaf": g1,
               "grad_gap_3rd_leaf": g3, "update_gap_worst_leaf": u1}
    if prog.get("picks"):
        scores = ref.get("proposal_scores", [])
        picked = ([pick_excess(p, s) for p, s in zip(prog["picks"], scores)]
                  if len(scores) == len(prog["picks"]) else [math.inf])
        numbers.update(pick_excess=picked[0], pick_excess_any_step=max(picked))
    return (numbers,
            {"grad_gap": g1_leaf, "update_gap": u1_leaf, "update_gap_3rd": u3_leaf,
             "top_update_gaps": [[n, update[n]] for n in sorted(update, key=update.get,
                                                               reverse=True)[:6]]})


def _rel(a, b):
    return np.abs(a - b) / (1.0 + np.abs(b))


def det_numbers(served, cands, topk):
    """served: [(frame index, dets [topk, 37])]; cands: {frame index:
    [Q * C, 37]} -> {score_gap, det_gap, score_gap_worst_entry,
    det_gap_worst_entry}.  Each served frame is judged as a whole: the root
    mean square of its sorted top-k score gaps, and of the column gaps of
    its detections to their nearest same-class candidates (nearest by that
    same mean); the numbers are the worst frame's.  The worst single entry
    is reported beside them."""
    out = dict.fromkeys(("score_gap", "det_gap", "score_gap_worst_entry",
                         "det_gap_worst_entry"), 0.0)
    for i, dets in served:
        c = cands[i]
        ref_top = np.sort(c[:, 1])[::-1][:topk]
        prog_top = np.sort(dets[:, 1])[::-1]
        if prog_top.shape != ref_top.shape or not np.all(np.isfinite(dets)):
            return dict.fromkeys(out, math.inf)
        d = np.abs(prog_top - ref_top)
        out["score_gap"] = max(out["score_gap"], float(np.sqrt(np.mean(d ** 2))))
        out["score_gap_worst_entry"] = max(out["score_gap_worst_entry"], float(d.max()))
        sq = []
        for row in dets:
            same = c[c[:, 0] == row[0]]
            if len(same) == 0:
                return dict.fromkeys(out, math.inf)
            rel = _rel(row[1:], same[:, 1:])
            k = int(np.argmin(np.mean(rel ** 2, 1)))
            sq.append(np.mean(rel[k] ** 2))
            out["det_gap_worst_entry"] = max(out["det_gap_worst_entry"],
                                             float(np.min(np.max(rel, 1))))
        out["det_gap"] = max(out["det_gap"], float(np.sqrt(np.mean(sq))))
    return out


def row_numbers(served_rows, served, decode, threshold):
    """served_rows: [(frame index, KITTI rows)], served: [(frame index,
    dets)] in the same order; decode(det, frame index) -> the reference's
    row.  Returns row_gap."""
    gap = 0.0
    for (i, rows), (j, dets) in zip(served_rows, served):
        kept = [d for d in dets if d[1] >= threshold]
        if i != j or len(kept) != len(rows):
            return math.inf
        for row, det in zip(rows, kept):
            want = np.asarray(decode(det, i), float)
            got = np.asarray(row, float)
            if got.shape != want.shape:
                return math.inf
            gap = max(gap, float(np.max(_rel(got, want))))
    return gap


def verdict(numbers, limits):
    """(correct, {name: {"value", "limit"}}) over the numbers that `limits`
    names: each at or under its limit, and finite."""
    shown = {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= v for k, v in limits.items())
    return ok, shown
