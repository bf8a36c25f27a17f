"""Rotated-rectangle BEV overlap, vectorized numpy.

Replaces the reference's numba-CUDA kernel (kitti_eval_python/rotate_iou.py:
convex polygon intersection of rotated boxes) with a fully vectorized
Sutherland–Hodgman clip over all N x M pairs at once: clipping one rectangle
(4 vertices, padded to a fixed 8-vertex buffer) against the 4 half-planes of
the other, then the shoelace area.  No GPU, no JIT — a handful of [P, 8]
array ops.  The evaluator calls the host kernel (`rotate_iou_eval`,
monodetr_torch/csrc/kitti_native.cpp); the numpy version
(`rotate_iou_eval_plain`) is its plain version, which the tests hold it to.

Box format: [cx, cz, l, w, ry] (BEV footprint; KITTI camera coords x-right,
z-forward, yaw around y).

criterion: -1 -> IoU, 0 -> inter/area1, 1 -> inter/area2, 2 -> raw
intersection area (reference rotate_iou.py:devRotateIoUEval semantics).
"""

import numpy as np

MAX_VERTS = 10  # 4-vertex subject clipped by 4 half-planes: at most 8 verts


def _box_corners(boxes):
    """[N, 5] -> [N, 4, 2] corner loop (counter-clockwise)."""
    cx, cz, l, w, ry = boxes.T
    cos, sin = np.cos(ry), np.sin(ry)
    dx = np.stack([l / 2, l / 2, -l / 2, -l / 2], -1)  # [N, 4]
    dz = np.stack([w / 2, -w / 2, -w / 2, w / 2], -1)
    x = cx[:, None] + dx * cos[:, None] + dz * sin[:, None]
    z = cz[:, None] - dx * sin[:, None] + dz * cos[:, None]
    return np.stack([x, z], -1)


def _polygon_area(pts, count):
    """Shoelace over [P, V, 2] with per-row vertex counts [P]."""
    P, V, _ = pts.shape
    idx = np.arange(V)
    valid = idx[None, :] < count[:, None]  # [P, V]
    nxt = (idx[None, :] + 1) % np.maximum(count[:, None], 1)
    x, z = pts[..., 0], pts[..., 1]
    xn = np.take_along_axis(x, nxt, axis=1)
    zn = np.take_along_axis(z, nxt, axis=1)
    cross = x * zn - xn * z
    return 0.5 * np.abs(np.where(valid, cross, 0.0).sum(-1))


def _clip_polygons(subject, count, edge_a, edge_b):
    """Clip polygons [P, V, 2] (counts [P]) against half-planes defined by
    directed edges a->b [P, 2]: keep the side where cross(b-a, p-a) >= 0."""
    P, V, _ = subject.shape
    d = edge_b - edge_a  # [P, 2]
    rel = subject - edge_a[:, None, :]
    dist = d[:, None, 0] * rel[..., 1] - d[:, None, 1] * rel[..., 0]  # [P, V]

    idx = np.arange(V)
    valid = idx[None, :] < count[:, None]
    nxt = (idx[None, :] + 1) % np.maximum(count[:, None], 1)
    dist_n = np.take_along_axis(dist, nxt, axis=1)
    pts_n = np.take_along_axis(subject, nxt[..., None].repeat(2, -1), axis=1)

    inside = dist >= 0
    inside_n = dist_n >= 0

    # intersection points of crossing edges
    t = dist / np.where(dist - dist_n == 0, 1e-30, dist - dist_n)
    inter = subject + (pts_n - subject) * t[..., None]

    # Emit per input vertex: [vertex if inside] + [intersection if crossing]
    emit_v = inside & valid
    emit_i = (inside != inside_n) & valid

    out = np.zeros((P, 2 * V, 2), subject.dtype)
    out_cnt = np.zeros(P, np.int64)
    # interleave: slot 2k = vertex k (if emitted), slot 2k+1 = intersection k
    # then compact.  Compaction via argsort of (not emitted, slot index).
    flat_pts = np.zeros((P, 2 * V, 2), subject.dtype)
    flat_pts[:, 0::2] = subject
    flat_pts[:, 1::2] = inter
    flat_emit = np.zeros((P, 2 * V), bool)
    flat_emit[:, 0::2] = emit_v
    flat_emit[:, 1::2] = emit_i

    order = np.argsort(~flat_emit, axis=1, kind="stable")  # emitted first
    gathered = np.take_along_axis(flat_pts, order[..., None].repeat(2, -1), axis=1)
    out_cnt = flat_emit.sum(-1)
    out[:, : 2 * V] = gathered
    return out[:, :V], np.minimum(out_cnt, V)


def rotated_box_intersection(boxes1, boxes2):
    """Pairwise intersection areas [N, M] of rotated BEV rectangles."""
    N, M = len(boxes1), len(boxes2)
    if N == 0 or M == 0:
        return np.zeros((N, M))
    c1 = _box_corners(boxes1.astype(np.float64))  # [N, 4, 2]
    c2 = _box_corners(boxes2.astype(np.float64))  # [M, 4, 2]

    P = N * M
    V = MAX_VERTS
    subject = np.zeros((P, V, 2))
    subject[:, :4] = np.repeat(c1, M, axis=0)
    count = np.full(P, 4, np.int64)
    clip = np.tile(c2, (N, 1, 1))  # [P, 4, 2]

    # ensure counter-clockwise clip polygons (cross of first corner > 0)
    u = clip[:, 1] - clip[:, 0]
    v = clip[:, 2] - clip[:, 0]
    area2x = u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]
    flip = area2x < 0
    clip[flip] = clip[flip][:, ::-1]

    for e in range(4):
        a = clip[:, e]
        b = clip[:, (e + 1) % 4]
        subject, count = _clip_polygons(subject, count, a, b)

    inter = _polygon_area(subject, count)
    return inter.reshape(N, M)


def rotate_iou_eval(boxes, qboxes, criterion=-1):
    """Reference rotate_iou_gpu_eval semantics over [N,5] x [M,5], by the
    host kernel (monodetr_torch/csrc/kitti_native.cpp:rotated_iou)."""
    from ... import native

    return native.rotated_iou(boxes, qboxes, criterion)


def rotate_iou_eval_plain(boxes, qboxes, criterion=-1):
    """rotate_iou_eval's plain version: the vectorized numpy clip."""
    boxes = np.asarray(boxes, np.float64)
    qboxes = np.asarray(qboxes, np.float64)
    inter = rotated_box_intersection(boxes, qboxes)
    area1 = (boxes[:, 2] * boxes[:, 3])[:, None]
    area2 = (qboxes[:, 2] * qboxes[:, 3])[None, :]
    if criterion == -1:
        denom = area1 + area2 - inter
    elif criterion == 0:
        denom = np.broadcast_to(area1, inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(area2, inter.shape)
    else:
        return inter.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = np.where(denom > 0, inter / denom, 0.0)
    return out.astype(np.float32)
