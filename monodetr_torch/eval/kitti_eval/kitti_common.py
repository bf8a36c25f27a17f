"""KITTI annotation/data I/O (reference kitti_eval_python/kitti_common.py).

Annotation dict arrays: name, truncated, occluded, alpha, bbox [N,4],
dimensions [N,3] in l,h,w (converted from the label file's h,w,l),
location [N,3], rotation_y [N], score [N].

Beyond the label I/O the eval path needs (:294-347), this also covers the
reference's info-building helpers (:15-150 — per-file paths, image-shape
probe, calib parsing, threaded get_kitti_image_info), anno filtering with
DontCare suppression (:152-189), KITTI result-line formatting (:204-247)
and the axis-aligned area/intersection/iou trio (:349-412), all asserted
equal against the reference implementation in
tests/test_kitti_common_extras.py.
"""

import pathlib
import re

import numpy as np


def get_image_index_str(img_idx):
    return "{:06d}".format(img_idx)


def get_label_anno(label_path):
    annotations = {}
    with open(label_path) as f:
        lines = f.readlines()
    content = [line.strip().split(" ") for line in lines if line.strip()]
    annotations["name"] = np.array([x[0] for x in content])
    annotations["truncated"] = np.array([float(x[1]) for x in content])
    annotations["occluded"] = np.array([int(float(x[2])) for x in content])
    annotations["alpha"] = np.array([float(x[3]) for x in content])
    annotations["bbox"] = np.array(
        [[float(v) for v in x[4:8]] for x in content]
    ).reshape(-1, 4)
    # label file stores h, w, l; standard camera order is l, h, w
    annotations["dimensions"] = np.array(
        [[float(v) for v in x[8:11]] for x in content]
    ).reshape(-1, 3)[:, [2, 0, 1]]
    annotations["location"] = np.array(
        [[float(v) for v in x[11:14]] for x in content]
    ).reshape(-1, 3)
    annotations["rotation_y"] = np.array([float(x[14]) for x in content]).reshape(-1)
    if len(content) != 0 and len(content[0]) == 16:
        annotations["score"] = np.array([float(x[15]) for x in content])
    else:
        annotations["score"] = np.zeros([len(annotations["bbox"])])
    return annotations


def get_label_annos(label_folder, image_ids=None):
    if image_ids is None:
        filepaths = pathlib.Path(label_folder).glob("*.txt")
        prog = re.compile(r"^\d{6}.txt$")
        filepaths = filter(lambda f: prog.match(f.name), filepaths)
        image_ids = sorted(int(p.stem) for p in filepaths)
    if not isinstance(image_ids, list):
        image_ids = list(range(image_ids))
    annos = []
    label_folder = pathlib.Path(label_folder)
    for idx in image_ids:
        label_filename = label_folder / (get_image_index_str(idx) + ".txt")
        annos.append(get_label_anno(label_filename))
    return annos


def filter_annos_low_score(image_annos, thresh):
    """Drop detections below a score threshold (kitti_common.py:191-206)."""
    new_annos = []
    for anno in image_annos:
        keep = [i for i, s in enumerate(anno["score"]) if s >= thresh]
        new_annos.append({k: v[keep] for k, v in anno.items()})
    return new_annos


def get_kitti_info_path(idx, prefix, info_type="image_2", file_tail=".png",
                        training=True, relative_path=True):
    """Path of one KITTI data file (kitti_common.py:15-34 parity): raises
    if the file does not exist."""
    rel = pathlib.Path("training" if training else "testing") / info_type / (
        get_image_index_str(idx) + file_tail)
    full = pathlib.Path(prefix) / rel
    if not full.exists():
        raise ValueError("file not exist: {}".format(rel))
    return str(rel) if relative_path else str(full)


def get_image_path(idx, prefix, training=True, relative_path=True):
    return get_kitti_info_path(idx, prefix, "image_2", ".png", training,
                               relative_path)


def get_label_path(idx, prefix, training=True, relative_path=True):
    return get_kitti_info_path(idx, prefix, "label_2", ".txt", training,
                               relative_path)


def get_velodyne_path(idx, prefix, training=True, relative_path=True):
    return get_kitti_info_path(idx, prefix, "velodyne", ".bin", training,
                               relative_path)


def get_calib_path(idx, prefix, training=True, relative_path=True):
    return get_kitti_info_path(idx, prefix, "calib", ".txt", training,
                               relative_path)


def _read_calib(calib_path, extend_matrix):
    """calib txt -> dict of projection/transform matrices, optionally
    extended to homogeneous 4x4."""
    def ext(m):
        return np.concatenate([m, [[0.0, 0.0, 0.0, 1.0]]], 0)

    with open(calib_path) as f:
        vals = [[float(x) for x in line.split(" ")[1:]]
                for line in f.read().strip().splitlines()]
    out = {}
    for i in range(4):
        P = np.array(vals[i][:12]).reshape(3, 4)
        out["calib/P%d" % i] = ext(P) if extend_matrix else P
    R0 = np.array(vals[4][:9]).reshape(3, 3)
    if extend_matrix:
        r4 = np.zeros((4, 4), R0.dtype)
        r4[3, 3] = 1.0
        r4[:3, :3] = R0
        R0 = r4
    out["calib/R0_rect"] = R0
    for name, row in (("Tr_velo_to_cam", 5), ("Tr_imu_to_velo", 6)):
        T = np.array(vals[row][:12]).reshape(3, 4)
        out["calib/" + name] = ext(T) if extend_matrix else T
    return out


def get_kitti_image_info(path, training=True, label_info=True,
                         velodyne=False, calib=False, image_ids=7481,
                         extend_matrix=True, num_worker=8,
                         relative_path=True, with_imageshape=True):
    """Per-image info dicts: paths, image shape, calib matrices,
    annotations with difficulty (kitti_common.py:61-150 parity; PIL
    instead of skimage for the shape probe — same (h, w) result)."""
    from concurrent import futures

    root = pathlib.Path(path)
    if not isinstance(image_ids, list):
        image_ids = list(range(image_ids))

    def one(idx):
        info = {"image_idx": idx}
        if velodyne:
            info["velodyne_path"] = get_velodyne_path(
                idx, path, training, relative_path)
        info["img_path"] = get_image_path(idx, path, training, relative_path)
        if with_imageshape:
            from PIL import Image

            p = root / info["img_path"] if relative_path else info["img_path"]
            with Image.open(p) as im:
                info["img_shape"] = np.array(
                    [im.height, im.width], np.int32)
        if label_info:
            lp = get_label_path(idx, path, training, relative_path)
            info["annos"] = get_label_anno(
                root / lp if relative_path else lp)
        if calib:
            info.update(_read_calib(
                get_calib_path(idx, path, training, relative_path=False),
                extend_matrix))
        if label_info:
            add_difficulty_to_annos(info)
        return info

    with futures.ThreadPoolExecutor(num_worker) as ex:
        return list(ex.map(one, image_ids))


def filter_kitti_anno(image_anno, used_classes, used_difficulty=None,
                      dontcare_iou=None):
    """Keep annotations of the given classes/difficulties; optionally drop
    boxes overlapping a DontCare region (kitti_common.py:152-189)."""
    if not isinstance(used_classes, (list, tuple)):
        used_classes = [used_classes]
    keep = np.array(
        [x in used_classes for x in image_anno["name"]], bool)
    out = {k: v[keep] for k, v in image_anno.items()}
    if used_difficulty is not None:
        keep = np.isin(out["difficulty"], used_difficulty)
        out = {k: v[keep] for k, v in out.items()}
    if "DontCare" in used_classes and dontcare_iou is not None:
        dc = out["name"] == "DontCare"
        ious = iou(out["bbox"], out["bbox"][dc])
        if ious.size > 0:
            keep = ~(np.amax(ious, axis=1) > dontcare_iou)
            out = {k: v[keep] for k, v in out.items()}
    return out


_RESULT_FIELDS = (
    ("name", None), ("truncated", -1), ("occluded", -1), ("alpha", -10),
    ("bbox", None), ("dimensions", [-1, -1, -1]),
    ("location", [-1000, -1000, -1000]), ("rotation_y", -10),
    ("score", None),
)


def kitti_result_line(result_dict, precision=4):
    """One KITTI result txt line from a per-object dict
    (kitti_common.py:204-247 parity: same field order, defaults and float
    formatting)."""
    fmt = "{:.%df}" % precision
    parts = []
    for key, default in _RESULT_FIELDS:
        val = result_dict.get(key)
        if val is None and default is None:
            raise ValueError("you must specify a value for {}".format(key))
        if key == "name":
            parts.append(val)
        elif key == "occluded":
            parts.append("{}".format(val if val is not None else default))
        elif key in ("bbox", "dimensions", "location"):
            vec = val if val is not None else default
            parts += [fmt.format(v) if val is not None else str(v)
                      for v in vec]
        else:
            parts.append(fmt.format(val) if val is not None else str(default))
    return " ".join(parts)


def area(boxes, add1=False):
    """[N,4] ([ymin,xmin,ymax,xmax]) -> [N] areas (kitti_common.py:349)."""
    a = 1.0 if add1 else 0.0
    return (boxes[:, 2] - boxes[:, 0] + a) * (boxes[:, 3] - boxes[:, 1] + a)


def intersection(boxes1, boxes2, add1=False):
    """Pairwise intersection areas [N,M] (kitti_common.py:365)."""
    a = 1.0 if add1 else 0.0
    lo = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    hi = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.maximum(0.0, hi - lo + a)
    return wh[..., 0] * wh[..., 1]


def iou(boxes1, boxes2, add1=False):
    """Pairwise IoU [N,M] (kitti_common.py:396)."""
    inter = intersection(boxes1, boxes2, add1)
    union = area(boxes1, add1)[:, None] + area(boxes2, add1)[None] - inter
    return inter / union


def add_difficulty_to_annos(info):
    """Tag each annotation with its KITTI difficulty 0/1/2 (-1 = none) —
    kitti_common.py:249-291."""
    min_height = [40, 25, 25]
    max_occlusion = [0, 1, 2]
    max_trunc = [0.15, 0.3, 0.5]
    annos = info["annos"]
    bbox = annos["bbox"]
    height = bbox[:, 3] - bbox[:, 1]
    occlusion = annos["occluded"]
    truncation = annos["truncated"]
    n = len(height)
    easy = np.ones(n, bool)
    moderate = np.ones(n, bool)
    hard = np.ones(n, bool)
    for i, (h, o, t) in enumerate(zip(height, occlusion, truncation)):
        if o > max_occlusion[0] or h <= min_height[0] or t > max_trunc[0]:
            easy[i] = False
        if o > max_occlusion[1] or h <= min_height[1] or t > max_trunc[1]:
            moderate[i] = False
        if o > max_occlusion[2] or h <= min_height[2] or t > max_trunc[2]:
            hard[i] = False
    is_moderate = np.logical_xor(easy, moderate)
    is_hard = np.logical_xor(hard, moderate)
    diff = []
    for i in range(n):
        if easy[i]:
            diff.append(0)
        elif is_moderate[i]:
            diff.append(1)
        elif is_hard[i]:
            diff.append(2)
        else:
            diff.append(-1)
    annos["difficulty"] = np.array(diff, np.int32)
    return diff
