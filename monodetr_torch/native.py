"""ctypes bindings for the host kernels of the loader and the evaluator
(csrc/kitti_native.cpp), built from source at first use by
`_build.host_library()` into build/monodetr_torch/host-<hash>/.

There is no quiet fallback: a failed build raises with the compiler's
output.  The plain versions (the PIL warp, `data/kitti_dataset.py:
warp_plain`; the numpy rotated IoU, `eval/kitti_eval/rotated_iou.py:
rotate_iou_eval_plain`; the numpy matcher, `eval/kitti_eval/eval.py:
_match_image_np`) are what the tests hold these kernels to.  ctypes releases
the GIL during the calls, so the threaded loader gets real parallelism out
of the C++ warp.
"""

import ctypes

import numpy as np

from . import _build


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def warp_affine_normalize(src: np.ndarray, trans_inv: np.ndarray,
                          dst_w: int, dst_h: int,
                          mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [dst_h, dst_w, 3] warped + normalized."""
    lib = _build.host_library()
    src = np.ascontiguousarray(src, np.uint8)
    inv = np.ascontiguousarray(trans_inv, np.float64)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if src.ndim != 3 or src.shape[2] != 3 or inv.size != 6 or mean.size != 3 or std.size != 3:
        raise ValueError(f"warp_affine_normalize: src {src.shape} (want [H, W, 3]), "
                         f"trans_inv {inv.shape}, mean {mean.shape}, std {std.shape}")
    out = np.empty((dst_h, dst_w, 3), np.float32)
    lib.warp_affine_normalize(
        _ptr(src, ctypes.c_uint8), src.shape[0], src.shape[1],
        _ptr(inv, ctypes.c_double),
        _ptr(out, ctypes.c_float), dst_h, dst_w,
        _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float),
    )
    return out


def rotated_iou(boxes: np.ndarray, qboxes: np.ndarray,
                criterion: int = -1) -> np.ndarray:
    """[N, 5] x [M, 5] BEV boxes (cx, cz, l, w, ry) -> float32 [N, M]."""
    lib = _build.host_library()
    boxes = np.ascontiguousarray(boxes, np.float64)
    qboxes = np.ascontiguousarray(qboxes, np.float64)
    if boxes.ndim != 2 or qboxes.ndim != 2 or boxes.shape[1] != 5 or qboxes.shape[1] != 5:
        raise ValueError(f"rotated_iou: boxes {boxes.shape} and {qboxes.shape}, want [N, 5]")
    n, m = len(boxes), len(qboxes)
    out = np.empty((n, m), np.float32)
    if n and m:
        lib.rotated_iou(_ptr(boxes, ctypes.c_double), n, _ptr(qboxes, ctypes.c_double), m,
                        criterion, _ptr(out, ctypes.c_float))
    return out


def match_image(overlaps, dt_scores, dt_alphas, gt_alphas, dt_bboxes,
                ignored_gt, ignored_det, dc_bboxes, metric, min_overlap,
                threshs, compute_fp, compute_aos):
    """C++ evaluator matching (per image, all thresholds).

    Returns (tp [T], fp [T], fn [T], sim [T], tp_scores: list of lists)."""
    lib = _build.host_library()
    D, G = overlaps.shape if overlaps.size else (len(dt_scores), len(ignored_gt))
    T = len(threshs)
    overlaps = np.ascontiguousarray(overlaps, np.float64)
    dt_scores = np.ascontiguousarray(dt_scores, np.float64)
    dt_alphas = np.ascontiguousarray(dt_alphas, np.float64)
    gt_alphas = np.ascontiguousarray(gt_alphas, np.float64)
    dt_bboxes = np.ascontiguousarray(dt_bboxes, np.float64)
    ignored_gt = np.ascontiguousarray(ignored_gt, np.int64)
    ignored_det = np.ascontiguousarray(ignored_det, np.int64)
    dc_bboxes = np.ascontiguousarray(dc_bboxes, np.float64)
    threshs = np.ascontiguousarray(threshs, np.float64)

    tp = np.zeros(T, np.int64)
    fp = np.zeros(T, np.int64)
    fn = np.zeros(T, np.int64)
    sim = np.zeros(T, np.float64)
    tp_scores = np.zeros((T, max(G, 1)), np.float64)
    tp_counts = np.zeros(T, np.int64)

    d, q = ctypes.c_double, ctypes.c_longlong
    lib.match_image(
        _ptr(overlaps, d), D, G,
        _ptr(dt_scores, d), _ptr(dt_alphas, d),
        _ptr(gt_alphas, d), _ptr(dt_bboxes, d),
        _ptr(ignored_gt, q), _ptr(ignored_det, q),
        _ptr(dc_bboxes, d), len(dc_bboxes),
        metric, min_overlap,
        _ptr(threshs, d), T,
        int(compute_fp), int(compute_aos),
        _ptr(tp, q), _ptr(fp, q), _ptr(fn, q),
        _ptr(sim, d), _ptr(tp_scores, d), _ptr(tp_counts, q),
    )
    scores = [tp_scores[t, : tp_counts[t]].tolist() for t in range(T)]
    return tp, fp, fn, sim, scores
