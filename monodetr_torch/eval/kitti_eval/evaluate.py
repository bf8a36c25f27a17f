"""Offline evaluation CLI (reference kitti_eval_python/evaluate.py, argparse
instead of fire):

    python -m monodetr_torch.eval.kitti_eval.evaluate \
        --label_path data/KITTIDataset/training/label_2 \
        --result_path outputs/monodetr/data \
        --label_split_file data/KITTIDataset/ImageSets/val.txt \
        --current_class 0 [--coco] [--score_thresh 0.2]
"""

import argparse

from . import kitti_common as kitti
from .eval import get_coco_eval_result, get_official_eval_result
from .kitti_common import filter_annos_low_score


def _read_imageset_file(path):
    with open(path) as f:
        return [int(line) for line in f.readlines()]


def evaluate(label_path, result_path, label_split_file, current_class=0,
             coco=False, score_thresh=-1):
    dt_annos = kitti.get_label_annos(result_path)
    if score_thresh > 0:
        dt_annos = filter_annos_low_score(dt_annos, score_thresh)
    val_image_ids = _read_imageset_file(label_split_file)
    gt_annos = kitti.get_label_annos(label_path, val_image_ids)
    if coco:
        return get_coco_eval_result(gt_annos, dt_annos, current_class)
    return get_official_eval_result(gt_annos, dt_annos, current_class)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--label_path", required=True)
    p.add_argument("--result_path", required=True)
    p.add_argument("--label_split_file", required=True)
    p.add_argument("--current_class", type=int, default=0)
    p.add_argument("--coco", action="store_true")
    p.add_argument("--score_thresh", type=float, default=-1)
    args = p.parse_args()
    out = evaluate(args.label_path, args.result_path, args.label_split_file,
                   args.current_class, args.coco, args.score_thresh)
    print(out[0] if isinstance(out, tuple) else out)
