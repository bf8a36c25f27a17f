"""ctypes bindings for the native host kernels (native/kitti_native.cpp).

The .so is optional: `available()` is False until `native/build.sh` has run,
and every caller has a pure-python fallback (PIL warp in the dataset, numpy
rotated IoU in the evaluator).  ctypes releases the GIL during the calls, so
the threaded loader gets real parallelism out of the C++ warp.
"""

import ctypes
import os

import numpy as np

_LIB = None
_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native", "libkitti_native.so",
)


def _load():
    global _LIB
    if _LIB is None and os.path.exists(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        lib.warp_affine_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.rotated_iou.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def warp_affine_normalize(src: np.ndarray, trans_inv: np.ndarray,
                          dst_w: int, dst_h: int,
                          mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [dst_h, dst_w, 3] warped + normalized."""
    lib = _load()
    src = np.ascontiguousarray(src, np.uint8)
    inv = np.ascontiguousarray(trans_inv, np.float64)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((dst_h, dst_w, 3), np.float32)
    lib.warp_affine_normalize(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        src.shape[0], src.shape[1],
        inv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dst_h, dst_w,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def rotated_iou(boxes: np.ndarray, qboxes: np.ndarray,
                criterion: int = -1) -> np.ndarray:
    lib = _load()
    boxes = np.ascontiguousarray(boxes, np.float64)
    qboxes = np.ascontiguousarray(qboxes, np.float64)
    n, m = len(boxes), len(qboxes)
    out = np.empty((n, m), np.float32)
    if n and m:
        lib.rotated_iou(
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
            qboxes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), m,
            criterion, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
    return out


def _setup_match(lib):
    import ctypes

    lib.match_image.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_longlong),
    ]


def match_image(overlaps, dt_scores, dt_alphas, gt_alphas, dt_bboxes,
                ignored_gt, ignored_det, dc_bboxes, metric, min_overlap,
                threshs, compute_fp, compute_aos):
    """C++ evaluator matching (per image, all thresholds).

    Returns (tp [T], fp [T], fn [T], sim [T], tp_scores: list of lists)."""
    import ctypes

    lib = _load()
    if not hasattr(lib, "_match_setup"):
        _setup_match(lib)
        lib._match_setup = True

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

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    c = ctypes
    lib.match_image(
        p(overlaps, c.c_double), D, G,
        p(dt_scores, c.c_double), p(dt_alphas, c.c_double),
        p(gt_alphas, c.c_double), p(dt_bboxes, c.c_double),
        p(ignored_gt, c.c_longlong), p(ignored_det, c.c_longlong),
        p(dc_bboxes, c.c_double), len(dc_bboxes),
        metric, min_overlap,
        p(threshs, c.c_double), T,
        int(compute_fp), int(compute_aos),
        p(tp, c.c_longlong), p(fp, c.c_longlong), p(fn, c.c_longlong),
        p(sim, c.c_double), p(tp_scores, c.c_double), p(tp_counts, c.c_longlong),
    )
    scores = [tp_scores[t, : tp_counts[t]].tolist() for t in range(T)]
    return tp, fp, fn, sim, scores
