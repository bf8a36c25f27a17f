"""Official KITTI AP / AP_R40 evaluation (bbox / BEV / 3D / AOS).

Capability parity with the reference's vendored kitti-object-eval-python
(`lib/datasets/kitti/kitti_eval_python/eval.py`) with the numba-JIT and
numba-CUDA kernels replaced by vectorized numpy:

  - rotated BEV overlap: Sutherland–Hodgman over all pairs at once
    (rotated_iou.py) instead of a CUDA polygon kernel;
  - the per-(image, threshold) greedy TP/FP/FN matching loop
    (compute_statistics_jit, eval.py:233-350) is re-derived as a single pass
    over ground-truth boxes with ALL 41 score thresholds advanced in
    parallel as a [T, D] state machine — the sequential dt scan reduces to
    a masked argmax (see `_match_image`);
  - 41-recall-point threshold selection, precision envelope, 11-pt and
    40-pt AP, AOS, and the official per-class overlap matrix are identical.

Public API: get_official_eval_result(gt_annos, dt_annos, classes) ->
(result_str, ret_dict, mAP3d_R40[class0, moderate]).
"""

import io as sysio

import numpy as np

from .rotated_iou import rotate_iou_eval

CLASS_NAMES = ["car", "pedestrian", "cyclist", "van", "person_sitting", "truck"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41
NO_DETECTION = -10000000


def get_thresholds(scores, num_gt, num_sample_pts=41):
    """Pick score thresholds at ~uniform recall steps (eval.py:9-27)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        if i < (len(scores) - 1):
            r_recall = (i + 2) / num_gt
        else:
            r_recall = l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) and (
            i < (len(scores) - 1)
        ):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_data(gt_anno, dt_anno, current_class, difficulty):
    """Difficulty filtering -> (num_valid_gt, ignored_gt, ignored_dt,
    dc_bboxes) with the reference's neighbour-class rules (eval.py:30-82)."""
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        bbox = gt_anno["bbox"][i]
        gt_name = gt_anno["name"][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (
            gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if dt_anno["name"][i].lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def clean_data_by_distance(gt_anno, dt_anno, current_class, difficulty):
    """Distance-bucketed filtering (eval.py:85-159, DISTANCE_COVER=False):
    difficulty indexes the distance band 0-30m / 30-50m / 50-70m, with the
    Hard occlusion/truncation/height gates applied throughout."""
    MAX_DISTANCE = [30, 50, 70]
    dc_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = CLASS_NAMES[current_class].lower()
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        bbox = gt_anno["bbox"][i]
        gt_name = gt_anno["name"][i].lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        dis = np.linalg.norm(gt_anno["location"][i])
        ignore = (
            gt_anno["occluded"][i] > MAX_OCCLUSION[2]
            or gt_anno["truncated"][i] > MAX_TRUNCATION[2]
            or height <= MIN_HEIGHT[2]
            or dis > MAX_DISTANCE[difficulty]
        )
        if difficulty > 0 and dis <= MAX_DISTANCE[difficulty - 1]:
            ignore = True
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_anno["name"][i] == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])
    for i in range(len(dt_anno["name"])):
        valid_class = 1 if dt_anno["name"][i].lower() == current_cls_name else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[2]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, dc_bboxes


def image_box_overlap(boxes, query_boxes, criterion=-1):
    """Axis-aligned 2D overlap [N, K], vectorized (eval.py:162-189)."""
    N, K = len(boxes), len(query_boxes)
    if N == 0 or K == 0:
        return np.zeros((N, K))
    iw = np.minimum(boxes[:, None, 2], query_boxes[None, :, 2]) - np.maximum(
        boxes[:, None, 0], query_boxes[None, :, 0]
    )
    ih = np.minimum(boxes[:, None, 3], query_boxes[None, :, 3]) - np.maximum(
        boxes[:, None, 1], query_boxes[None, :, 1]
    )
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area = lambda b: (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    if criterion == -1:
        ua = area(boxes)[:, None] + area(query_boxes)[None, :] - inter
    elif criterion == 0:
        ua = np.broadcast_to(area(boxes)[:, None], inter.shape)
    elif criterion == 1:
        ua = np.broadcast_to(area(query_boxes)[None, :], inter.shape)
    else:
        ua = np.ones_like(inter)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(inter > 0, inter / ua, 0.0)


def bev_box_overlap(boxes, qboxes, criterion=-1):
    return rotate_iou_eval(boxes, qboxes, criterion)


def d3_box_overlap(boxes, qboxes, criterion=-1):
    """3D overlap: rotated BEV intersection x y-extent overlap
    (eval.py:197-230).  boxes: [N, 7] (x, y, z, l, h, w, ry); y is the
    box *bottom* in camera coords, extent grows upward (-y)."""
    rinc = rotate_iou_eval(boxes[:, [0, 2, 3, 5, 6]], qboxes[:, [0, 2, 3, 5, 6]], 2)
    N, K = rinc.shape
    if N == 0 or K == 0:
        return rinc
    iw = np.minimum(boxes[:, None, 1], qboxes[None, :, 1]) - np.maximum(
        boxes[:, None, 1] - boxes[:, None, 4],
        qboxes[None, :, 1] - qboxes[None, :, 4],
    )
    vol1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    vol2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = np.where(iw > 0, iw * rinc, 0.0)
    if criterion == -1:
        ua = vol1 + vol2 - inc
    elif criterion == 0:
        ua = np.broadcast_to(vol1, inc.shape)
    elif criterion == 1:
        ua = np.broadcast_to(vol2, inc.shape)
    else:
        ua = inc
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where((rinc > 0) & (iw > 0), inc / ua, 0.0)
    return out


def _match_image(overlaps, gt_data, dt_data, ignored_gt, ignored_det,
                 dc_bboxes, metric, min_overlap, threshs, compute_fp,
                 compute_aos):
    """One image's matching by the host kernel (monodetr_torch/csrc/
    kitti_native.cpp:match_image); an image without ground truth or
    detections takes the numpy path, as the JAX package's evaluator does."""
    from ... import native
    if len(gt_data) and len(dt_data):
        return native.match_image(
            np.asarray(overlaps, np.float64),
            dt_data[:, -1], dt_data[:, 4],
            gt_data[:, 4] if len(gt_data) else np.zeros(0),
            dt_data[:, :4], ignored_gt, ignored_det,
            np.asarray(dc_bboxes, np.float64).reshape(-1, 4),
            metric, float(min_overlap), np.asarray(threshs, np.float64),
            compute_fp, compute_aos,
        )
    return _match_image_np(
        overlaps, gt_data, dt_data, ignored_gt, ignored_det, dc_bboxes,
        metric, min_overlap, threshs, compute_fp, compute_aos,
    )


def _match_image_np(overlaps, gt_data, dt_data, ignored_gt, ignored_det,
                    dc_bboxes, metric, min_overlap, threshs, compute_fp,
                    compute_aos):
    """TP/FP/FN/similarity for one image at T thresholds simultaneously.

    The plain version of the host kernel's match_image
    (monodetr_torch/csrc/kitti_native.cpp, the equivalent of the
    reference's numba compute_statistics_jit), which the tests hold it to;
    `_match_image` takes it only for an image without ground truth or
    detections.

    Numpy re-derivation of the reference's sequential dt scan
    (compute_statistics_jit, eval.py:267-316): for each gt in order, the
    scan selects
      - compute_fp=False: the not-yet-assigned candidate with max score;
      - compute_fp=True: the max-overlap candidate among real (ignored 0)
        dts if any, else the first ignored(1) candidate.
    Both reduce to masked argmax over the dt axis, carried for all T
    threshold rows at once.  Returns (tp, fp, fn, sim [T], tp_scores list).
    """
    T = len(threshs)
    D = len(dt_data)
    G = len(gt_data)
    dt_scores = dt_data[:, -1] if D else np.zeros(0)
    dt_alphas = dt_data[:, 4] if D else np.zeros(0)
    gt_alphas = gt_data[:, 4] if G else np.zeros(0)

    ignored_thresh = (
        dt_scores[None, :] < np.asarray(threshs)[:, None]
        if compute_fp
        else np.zeros((T, D), bool)
    )  # [T, D]
    assigned = np.zeros((T, D), bool)
    tp = np.zeros(T, np.int64)
    fn = np.zeros(T, np.int64)
    sim = np.zeros(T, np.float64)
    tp_any = np.zeros(T, bool)
    tp_scores = [[] for _ in range(T)]

    ig_det = np.asarray(ignored_det, np.int64) if D else np.zeros(0, np.int64)
    usable = ig_det[None, :] != -1  # [T, D]

    if D == 0:
        fp = np.zeros(T, np.int64)
        for i in range(G):
            if ignored_gt[i] == 0:
                fn += 1
        if compute_fp and compute_aos:
            sim = np.where((tp == 0) & (fp == 0), -1.0, sim)
        return tp, fp, fn, sim, tp_scores

    for i in range(G):
        if ignored_gt[i] == -1:
            continue
        ov = overlaps[:, i] if D else np.zeros(0)  # [D] (overlaps is [D, G])
        cand = usable & ~assigned & ~ignored_thresh & (ov[None, :] > min_overlap)
        if not compute_fp:
            # pick max score among candidates (first index on ties)
            score_masked = np.where(cand, dt_scores[None, :], -np.inf)
            det = np.argmax(score_masked, axis=1)
            has = cand.any(axis=1)
        else:
            cand0 = cand & (ig_det[None, :] == 0)
            cand1 = cand & (ig_det[None, :] == 1)
            ov_masked = np.where(cand0, ov[None, :], -np.inf)
            det0 = np.argmax(ov_masked, axis=1)
            has0 = cand0.any(axis=1)
            det1 = np.argmax(cand1, axis=1)
            has1 = cand1.any(axis=1)
            det = np.where(has0, det0, det1)
            has = has0 | has1

        if ignored_gt[i] == 0:
            fn += ~has
        det_ignored = np.where(
            has, (ignored_gt[i] == 1) | (ig_det[det] == 1), False
        )
        is_tp = has & ~det_ignored
        tp += is_tp
        tp_any |= is_tp
        if compute_aos:
            delta = gt_alphas[i] - np.where(D > 0, dt_alphas[det], 0.0)
            sim += np.where(is_tp, (1.0 + np.cos(delta)) / 2.0, 0.0)
        rows = np.nonzero(is_tp)[0]
        for t in rows:
            tp_scores[t].append(dt_scores[det[t]])
        assigned[np.nonzero(has)[0], det[has]] = True

    fp = np.zeros(T, np.int64)
    if compute_fp:
        fp_mask = ~assigned & (ig_det[None, :] == 0) & ~ignored_thresh
        fp = fp_mask.sum(axis=1)
        if metric == 0 and len(dc_bboxes):
            dt_bboxes = dt_data[:, :4]
            ov_dc = image_box_overlap(dt_bboxes, np.asarray(dc_bboxes), 0)  # [D, C]
            stuffable = fp_mask & (ov_dc.max(axis=1)[None, :] > min_overlap)
            fp -= stuffable.sum(axis=1)
        if compute_aos:
            # reference: similarity = sum over tp of (1+cos d)/2, fp add 0;
            # rows with no tp and no fp get similarity -1 (ignored later)
            none = (tp == 0) & (fp == 0)
            sim = np.where(none, -1.0, sim)
    return tp, fp, fn, sim, tp_scores


def get_split_parts(num, num_part):
    same_part = num // num_part
    remain_num = num % num_part
    if same_part == 0:
        return [num]
    if remain_num == 0:
        return [same_part] * num_part
    return [same_part] * num_part + [remain_num]


def calculate_iou_partly(gt_annos, dt_annos, metric, num_parts=50):
    """Per-image overlap matrices, computed in concatenated parts
    (eval.py:415-489).  Returns per-image [n_gt_i, n_dt_i]... note the
    reference calls this with (dt, gt) swapped so rows are detections."""
    assert len(gt_annos) == len(dt_annos)
    total_dt_num = np.array([len(a["name"]) for a in dt_annos])
    total_gt_num = np.array([len(a["name"]) for a in gt_annos])
    split_parts = get_split_parts(len(gt_annos), num_parts)
    parted_overlaps = []
    example_idx = 0
    for num_part in split_parts:
        gt_part = gt_annos[example_idx:example_idx + num_part]
        dt_part = dt_annos[example_idx:example_idx + num_part]
        if metric == 0:
            gt_boxes = np.concatenate([a["bbox"] for a in gt_part], 0)
            dt_boxes = np.concatenate([a["bbox"] for a in dt_part], 0)
            overlap_part = image_box_overlap(gt_boxes, dt_boxes)
        elif metric == 1:
            gt_boxes = np.concatenate(
                [
                    np.concatenate(
                        [a["location"][:, [0, 2]], a["dimensions"][:, [0, 2]],
                         a["rotation_y"][..., None]], 1,
                    )
                    for a in gt_part
                ],
                0,
            )
            dt_boxes = np.concatenate(
                [
                    np.concatenate(
                        [a["location"][:, [0, 2]], a["dimensions"][:, [0, 2]],
                         a["rotation_y"][..., None]], 1,
                    )
                    for a in dt_part
                ],
                0,
            )
            overlap_part = bev_box_overlap(gt_boxes, dt_boxes).astype(np.float64)
        elif metric == 2:
            gt_boxes = np.concatenate(
                [
                    np.concatenate(
                        [a["location"], a["dimensions"], a["rotation_y"][..., None]], 1
                    )
                    for a in gt_part
                ],
                0,
            )
            dt_boxes = np.concatenate(
                [
                    np.concatenate(
                        [a["location"], a["dimensions"], a["rotation_y"][..., None]], 1
                    )
                    for a in dt_part
                ],
                0,
            )
            overlap_part = d3_box_overlap(gt_boxes, dt_boxes).astype(np.float64)
        else:
            raise ValueError("unknown metric")
        parted_overlaps.append(overlap_part)
        example_idx += num_part

    overlaps = []
    example_idx = 0
    for j, num_part in enumerate(split_parts):
        gt_num_idx, dt_num_idx = 0, 0
        for i in range(num_part):
            gt_box_num = total_gt_num[example_idx + i]
            dt_box_num = total_dt_num[example_idx + i]
            overlaps.append(
                parted_overlaps[j][
                    gt_num_idx:gt_num_idx + gt_box_num,
                    dt_num_idx:dt_num_idx + dt_box_num,
                ]
            )
            gt_num_idx += gt_box_num
            dt_num_idx += dt_box_num
        example_idx += num_part
    return overlaps, parted_overlaps, total_gt_num, total_dt_num


def _prepare_data(gt_annos, dt_annos, current_class, difficulty,
                  by_distance=False):
    gt_datas_list, dt_datas_list = [], []
    ignored_gts, ignored_dets, dontcares = [], [], []
    total_num_valid_gt = 0
    cleaner = clean_data_by_distance if by_distance else clean_data
    for i in range(len(gt_annos)):
        num_valid_gt, ignored_gt, ignored_det, dc_bboxes = cleaner(
            gt_annos[i], dt_annos[i], current_class, difficulty
        )
        ignored_gts.append(np.array(ignored_gt, np.int64))
        ignored_dets.append(np.array(ignored_det, np.int64))
        dontcares.append(
            np.stack(dc_bboxes, 0).astype(np.float64)
            if dc_bboxes
            else np.zeros((0, 4))
        )
        total_num_valid_gt += num_valid_gt
        gt_datas_list.append(
            np.concatenate([gt_annos[i]["bbox"], gt_annos[i]["alpha"][..., None]], 1)
        )
        dt_datas_list.append(
            np.concatenate(
                [
                    dt_annos[i]["bbox"],
                    dt_annos[i]["alpha"][..., None],
                    dt_annos[i]["score"][..., None],
                ],
                1,
            )
        )
    return (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
            dontcares, total_num_valid_gt)


def eval_class(gt_annos, dt_annos, current_classes, difficultys, metric,
               min_overlaps, compute_aos=False, num_parts=50,
               by_distance=False):
    assert len(gt_annos) == len(dt_annos)
    overlaps, _, _, _ = calculate_iou_partly(dt_annos, gt_annos, metric, num_parts)
    # overlaps[i] is [n_dt_i, n_gt_i] (dt first — matches the reference call)

    num_minoverlap = len(min_overlaps)
    num_class = len(current_classes)
    num_difficulty = len(difficultys)
    precision = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    recall = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])
    aos = np.zeros([num_class, num_difficulty, num_minoverlap, N_SAMPLE_PTS])

    for m, current_class in enumerate(current_classes):
        for l, difficulty in enumerate(difficultys):
            (gt_datas_list, dt_datas_list, ignored_gts, ignored_dets,
             dontcares, total_num_valid_gt) = _prepare_data(
                gt_annos, dt_annos, current_class, difficulty,
                by_distance=by_distance,
            )
            for k, min_overlap in enumerate(min_overlaps[:, metric, m]):
                # pass 1: collect tp scores at threshold 0
                all_scores = []
                for i in range(len(gt_annos)):
                    _, _, _, _, tp_scores = _match_image(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap, [0.0], compute_fp=False,
                        compute_aos=False,
                    )
                    all_scores += tp_scores[0]
                thresholds = np.array(
                    get_thresholds(np.array(all_scores), total_num_valid_gt)
                )
                if len(thresholds) == 0:
                    continue
                pr = np.zeros([len(thresholds), 4])
                for i in range(len(gt_annos)):
                    tp, fp, fn, sim, _ = _match_image(
                        overlaps[i], gt_datas_list[i], dt_datas_list[i],
                        ignored_gts[i], ignored_dets[i], dontcares[i],
                        metric, min_overlap, thresholds, compute_fp=True,
                        compute_aos=compute_aos,
                    )
                    pr[:, 0] += tp
                    pr[:, 1] += fp
                    pr[:, 2] += fn
                    pr[:, 3] += np.where(sim != -1, sim, 0.0)
                for i in range(len(thresholds)):
                    recall[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                    precision[m, l, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                    if compute_aos:
                        aos[m, l, k, i] = pr[i, 3] / (pr[i, 0] + pr[i, 1])
                for i in range(len(thresholds)):
                    precision[m, l, k, i] = np.max(precision[m, l, k, i:], axis=-1)
                    recall[m, l, k, i] = np.max(recall[m, l, k, i:], axis=-1)
                    if compute_aos:
                        aos[m, l, k, i] = np.max(aos[m, l, k, i:], axis=-1)
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_mAP(prec):
    sums = 0
    for i in range(0, prec.shape[-1], 4):
        sums = sums + prec[..., i]
    return sums / 11 * 100


def get_mAP_R40(prec):
    sums = 0
    for i in range(1, prec.shape[-1]):
        sums = sums + prec[..., i]
    return sums / 40 * 100


def print_str(value, *arg, sstream=None):
    if sstream is None:
        sstream = sysio.StringIO()
    sstream.truncate(0)
    sstream.seek(0)
    print(value, *arg, file=sstream)
    return sstream.getvalue()


def do_eval(gt_annos, dt_annos, current_classes, min_overlaps,
            compute_aos=False, PR_detail_dict=None, by_distance=False):
    difficultys = [0, 1, 2]
    ret = eval_class(
        gt_annos, dt_annos, current_classes, difficultys, 0, min_overlaps,
        compute_aos, by_distance=by_distance,
    )
    mAP_bbox = get_mAP(ret["precision"])
    mAP_bbox_R40 = get_mAP_R40(ret["precision"])
    if PR_detail_dict is not None:
        PR_detail_dict["bbox"] = ret["precision"]
    mAP_aos = mAP_aos_R40 = None
    if compute_aos:
        mAP_aos = get_mAP(ret["orientation"])
        mAP_aos_R40 = get_mAP_R40(ret["orientation"])
        if PR_detail_dict is not None:
            PR_detail_dict["aos"] = ret["orientation"]
    ret = eval_class(
        gt_annos, dt_annos, current_classes, difficultys, 1, min_overlaps,
        by_distance=by_distance,
    )
    mAP_bev = get_mAP(ret["precision"])
    mAP_bev_R40 = get_mAP_R40(ret["precision"])
    if PR_detail_dict is not None:
        PR_detail_dict["bev"] = ret["precision"]
    ret = eval_class(
        gt_annos, dt_annos, current_classes, difficultys, 2, min_overlaps,
        by_distance=by_distance,
    )
    mAP_3d = get_mAP(ret["precision"])
    mAP_3d_R40 = get_mAP_R40(ret["precision"])
    if PR_detail_dict is not None:
        PR_detail_dict["3d"] = ret["precision"]
    return (mAP_bbox, mAP_bev, mAP_3d, mAP_aos,
            mAP_bbox_R40, mAP_bev_R40, mAP_3d_R40, mAP_aos_R40)


def get_official_eval_result(gt_annos, dt_annos, current_classes,
                             PR_detail_dict=None):
    overlap_0_7 = np.array(
        [[0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
         [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
         [0.7, 0.5, 0.5, 0.7, 0.5, 0.7]]
    )
    overlap_0_5 = np.array(
        [[0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
         [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
         [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]]
    )
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)
    class_to_name = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
                     4: "Person_sitting", 5: "Truck"}
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c] if isinstance(c, str) else c for c in current_classes
    ]
    min_overlaps = min_overlaps[:, :, current_classes]
    result = ""
    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break

    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos,
        PR_detail_dict=PR_detail_dict,
    )

    ret_dict = {}
    for j, curcls in enumerate(current_classes):
        for i in range(min_overlaps.shape[0]):
            result += print_str(
                f"{class_to_name[curcls]} "
                "AP@{:.2f}, {:.2f}, {:.2f}:".format(*min_overlaps[i, :, j])
            )
            result += print_str(
                f"bbox AP:{mAPbbox[j, 0, i]:.4f}, {mAPbbox[j, 1, i]:.4f}, "
                f"{mAPbbox[j, 2, i]:.4f}"
            )
            result += print_str(
                f"bev  AP:{mAPbev[j, 0, i]:.4f}, {mAPbev[j, 1, i]:.4f}, "
                f"{mAPbev[j, 2, i]:.4f}"
            )
            result += print_str(
                f"3d   AP:{mAP3d[j, 0, i]:.4f}, {mAP3d[j, 1, i]:.4f}, "
                f"{mAP3d[j, 2, i]:.4f}"
            )
            if compute_aos:
                result += print_str(
                    f"aos  AP:{mAPaos[j, 0, i]:.2f}, {mAPaos[j, 1, i]:.2f}, "
                    f"{mAPaos[j, 2, i]:.2f}"
                )
                if i == 0:
                    ret_dict[f"{class_to_name[curcls]}_aos_easy"] = mAPaos[j, 0, 0]
                    ret_dict[f"{class_to_name[curcls]}_aos_moderate"] = mAPaos[j, 1, 0]
                    ret_dict[f"{class_to_name[curcls]}_aos_hard"] = mAPaos[j, 2, 0]
            result += print_str(
                f"{class_to_name[curcls]} "
                "AP_R40@{:.2f}, {:.2f}, {:.2f}:".format(*min_overlaps[i, :, j])
            )
            result += print_str(
                f"bbox AP:{mAPbbox_R40[j, 0, i]:.4f}, {mAPbbox_R40[j, 1, i]:.4f}, "
                f"{mAPbbox_R40[j, 2, i]:.4f}"
            )
            result += print_str(
                f"bev  AP:{mAPbev_R40[j, 0, i]:.4f}, {mAPbev_R40[j, 1, i]:.4f}, "
                f"{mAPbev_R40[j, 2, i]:.4f}"
            )
            result += print_str(
                f"3d   AP:{mAP3d_R40[j, 0, i]:.4f}, {mAP3d_R40[j, 1, i]:.4f}, "
                f"{mAP3d_R40[j, 2, i]:.4f}"
            )
            if compute_aos:
                result += print_str(
                    f"aos  AP:{mAPaos_R40[j, 0, i]:.2f}, "
                    f"{mAPaos_R40[j, 1, i]:.2f}, {mAPaos_R40[j, 2, i]:.2f}"
                )
                if i == 0:
                    ret_dict[f"{class_to_name[curcls]}_aos_easy_R40"] = mAPaos_R40[j, 0, 0]
                    ret_dict[f"{class_to_name[curcls]}_aos_moderate_R40"] = mAPaos_R40[j, 1, 0]
                    ret_dict[f"{class_to_name[curcls]}_aos_hard_R40"] = mAPaos_R40[j, 2, 0]
            if i == 0:
                name = class_to_name[curcls]
                for di, dn in enumerate(["easy", "moderate", "hard"]):
                    ret_dict[f"{name}_3d_{dn}"] = mAP3d[j, di, 0]
                    ret_dict[f"{name}_bev_{dn}"] = mAPbev[j, di, 0]
                    ret_dict[f"{name}_image_{dn}"] = mAPbbox[j, di, 0]
                    ret_dict[f"{name}_3d_{dn}_R40"] = mAP3d_R40[j, di, 0]
                    ret_dict[f"{name}_bev_{dn}_R40"] = mAPbev_R40[j, di, 0]
                    ret_dict[f"{name}_image_{dn}_R40"] = mAPbbox_R40[j, di, 0]

    return result, ret_dict, mAP3d_R40[0, 1, 0]


def get_distance_eval_result(gt_annos, dt_annos, current_classes,
                             PR_detail_dict=None):
    """Distance-bucketed AP (30m / 50m / 70m bands) — reference
    eval.py:828-936 (get_distance_eval_result)."""
    overlap_0_7 = np.array(
        [[0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
         [0.7, 0.5, 0.5, 0.7, 0.5, 0.7],
         [0.7, 0.5, 0.5, 0.7, 0.5, 0.7]]
    )
    overlap_0_5 = np.array(
        [[0.7, 0.5, 0.5, 0.7, 0.5, 0.5],
         [0.5, 0.25, 0.25, 0.5, 0.25, 0.5],
         [0.5, 0.25, 0.25, 0.5, 0.25, 0.5]]
    )
    min_overlaps = np.stack([overlap_0_7, overlap_0_5], axis=0)
    class_to_name = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
                     4: "Person_sitting", 5: "Truck"}
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c] if isinstance(c, str) else c for c in current_classes
    ]
    min_overlaps = min_overlaps[:, :, current_classes]
    result = ""
    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break

    (mAPbbox, mAPbev, mAP3d, mAPaos, mAPbbox_R40, mAPbev_R40, mAP3d_R40,
     mAPaos_R40) = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos,
        PR_detail_dict=PR_detail_dict, by_distance=True,
    )

    ret_dict = {}
    bands = ["30m", "50m", "70m"]
    for j, curcls in enumerate(current_classes):
        name = class_to_name[curcls]
        for i in range(min_overlaps.shape[0]):
            result += print_str(
                f"{name} AP(distance)@{{:.2f}}, {{:.2f}}, {{:.2f}}:".format(
                    *min_overlaps[i, :, j]
                )
            )
            result += print_str(
                f"bbox AP:{mAPbbox[j, 0, i]:.4f}, {mAPbbox[j, 1, i]:.4f}, "
                f"{mAPbbox[j, 2, i]:.4f}"
            )
            result += print_str(
                f"bev  AP:{mAPbev[j, 0, i]:.4f}, {mAPbev[j, 1, i]:.4f}, "
                f"{mAPbev[j, 2, i]:.4f}"
            )
            result += print_str(
                f"3d   AP:{mAP3d[j, 0, i]:.4f}, {mAP3d[j, 1, i]:.4f}, "
                f"{mAP3d[j, 2, i]:.4f}"
            )
            result += print_str(
                f"3d R40:{mAP3d_R40[j, 0, i]:.4f}, {mAP3d_R40[j, 1, i]:.4f}, "
                f"{mAP3d_R40[j, 2, i]:.4f}"
            )
            if i == 0:
                for di, dn in enumerate(bands):
                    ret_dict[f"{name}_3d_{dn}"] = mAP3d[j, di, 0]
                    ret_dict[f"{name}_bev_{dn}"] = mAPbev[j, di, 0]
                    ret_dict[f"{name}_image_{dn}"] = mAPbbox[j, di, 0]
                    ret_dict[f"{name}_3d_{dn}_R40"] = mAP3d_R40[j, di, 0]
                    ret_dict[f"{name}_bev_{dn}_R40"] = mAPbev_R40[j, di, 0]
                    ret_dict[f"{name}_image_{dn}_R40"] = mAPbbox_R40[j, di, 0]
    return result, ret_dict


def do_coco_style_eval(gt_annos, dt_annos, current_classes, overlap_ranges,
                       compute_aos):
    """AP averaged over an overlap sweep (reference eval.py:699-714)."""
    min_overlaps = np.zeros([10, *overlap_ranges.shape[1:]])
    for i in range(overlap_ranges.shape[1]):
        for j in range(overlap_ranges.shape[2]):
            lo, hi, n = overlap_ranges[:, i, j]
            min_overlaps[:, i, j] = np.linspace(lo, hi, int(n))
    (mAP_bbox, mAP_bev, mAP_3d, mAP_aos, *_rest) = do_eval(
        gt_annos, dt_annos, current_classes, min_overlaps, compute_aos
    )
    mAP_bbox = mAP_bbox.mean(-1)
    mAP_bev = mAP_bev.mean(-1)
    mAP_3d = mAP_3d.mean(-1)
    if mAP_aos is not None:
        mAP_aos = mAP_aos.mean(-1)
    return mAP_bbox, mAP_bev, mAP_3d, mAP_aos


def get_coco_eval_result(gt_annos, dt_annos, current_classes):
    """COCO-style AP over 10 overlap thresholds (reference eval.py:939-998)."""
    class_to_name = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
                     4: "Person_sitting"}
    class_to_range = {
        0: [0.5, 0.95, 10], 1: [0.25, 0.7, 10], 2: [0.25, 0.7, 10],
        3: [0.5, 0.95, 10], 4: [0.25, 0.7, 10],
    }
    name_to_class = {v: n for n, v in class_to_name.items()}
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    current_classes = [
        name_to_class[c] if isinstance(c, str) else c for c in current_classes
    ]
    overlap_ranges = np.zeros([3, 3, len(current_classes)])
    for i, curcls in enumerate(current_classes):
        overlap_ranges[:, :, i] = np.array(class_to_range[curcls])[:, None]
    result = ""
    compute_aos = False
    for anno in dt_annos:
        if anno["alpha"].shape[0] != 0:
            if anno["alpha"][0] != -10:
                compute_aos = True
            break
    mAPbbox, mAPbev, mAP3d, mAPaos = do_coco_style_eval(
        gt_annos, dt_annos, current_classes, overlap_ranges, compute_aos
    )
    for j, curcls in enumerate(current_classes):
        o_range = np.array(class_to_range[curcls])[[0, 2, 1]]
        o_range[1] = (o_range[2] - o_range[0]) / (o_range[1] - 1)
        result += print_str(
            f"{class_to_name[curcls]} "
            "coco AP@{:.2f}:{:.2f}:{:.2f}:".format(*o_range)
        )
        result += print_str(
            f"bbox AP:{mAPbbox[j, 0]:.2f}, {mAPbbox[j, 1]:.2f}, "
            f"{mAPbbox[j, 2]:.2f}"
        )
        result += print_str(
            f"bev  AP:{mAPbev[j, 0]:.2f}, {mAPbev[j, 1]:.2f}, "
            f"{mAPbev[j, 2]:.2f}"
        )
        result += print_str(
            f"3d   AP:{mAP3d[j, 0]:.2f}, {mAP3d[j, 1]:.2f}, {mAP3d[j, 2]:.2f}"
        )
        if compute_aos:
            result += print_str(
                f"aos  AP:{mAPaos[j, 0]:.2f}, {mAPaos[j, 1]:.2f}, "
                f"{mAPaos[j, 2]:.2f}"
            )
    return result
