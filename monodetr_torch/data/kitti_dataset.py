"""KITTI dataset: host-side numpy pipeline producing fixed-shape batches.

Behavior parity with reference lib/datasets/kitti/kitti_dataset.py
(KITTI_Dataset) — photometric distort / flip / scale-shift crop
augmentations, affine warp to 1280x384, ImageNet normalization, and padded
[max_objs=50] target encoding (writelist/level/depth-range/center-in-image
filters, cxcylrtb 6-D boxes, heading bin+residual, mask_2d) — pinned by the
executable goldens in tests/test_golden_dataset.py, which run the
reference's own __getitem__ side by side.

The implementation is NOT the reference's: labels parse into a
struct-of-arrays LabelTable and the whole target encoding is vectorized
over objects (one affine matmul, one projection, one heading-bin pass for
all boxes; the reference loops python per object, kitti_dataset.py:208-305).
Differences by design:

  - images come out NHWC (TPU layout) instead of CHW;
  - targets stay padded + masked (the reference re-raggedizes them in
    trainer_helper.prepare_targets; our criterion consumes the mask
    directly);
  - `mask` is the reference's `mask_2d` (trunc<=0.5 & occ<=2 filter).
"""

import os
from typing import Any, Dict

import numpy as np
from PIL import Image, ImageFile

ImageFile.LOAD_TRUNCATED_IMAGES = True

from .. import native
from .augment import PhotometricDistort
from .kitti_utils import (
    Calibration,
    affine_transform,
    get_affine_transform,
    read_label,
)

NUM_HEADING_BIN = 12


def warp_plain(img, trans_inv, resolution, mean, std):
    """The plain version of native.warp_affine_normalize: PIL's bilinear
    affine warp of `img` (a PIL image) to `resolution` (W, H), then /255
    and the ImageNet normalization, NHWC.  PIL rounds the warped image to
    uint8 before the normalization (the native kernel does not) and treats
    the border's samples differently."""
    img = img.transform(
        tuple(int(v) for v in resolution),
        method=Image.AFFINE,
        data=tuple(np.asarray(trans_inv).reshape(-1).tolist()),
        resample=Image.BILINEAR,
    )
    img = np.array(img).astype(np.float32) / 255.0
    return (img - mean) / std  # NHWC stays


class KITTIDataset:
    def __init__(self, split: str, cfg: Dict[str, Any]):
        self.root_dir = cfg.get("root_dir")
        self.split = split
        self.num_classes = 3
        self.max_objs = 50
        self.class_name = ["Pedestrian", "Car", "Cyclist"]
        self.cls2id = {"Pedestrian": 0, "Car": 1, "Cyclist": 2}
        # W, H — configurable (the reference hardcodes 1280x384,
        # kitti_dataset.py:32); the 2x stress config and small-res tests
        # override it.  Must be divisible by 64 (4 feature levels + /64 synth).
        self.resolution = np.array(cfg.get("resolution", [1280, 384]))
        self.use_3d_center = cfg.get("use_3d_center", True)
        self.writelist = list(cfg.get("writelist", ["Car"]))
        self.bbox2d_type = cfg.get("bbox2d_type", "anno")
        self.meanshape = cfg.get("meanshape", False)
        self.class_merging = cfg.get("class_merging", False)
        self.use_dontcare = cfg.get("use_dontcare", False)
        if self.class_merging:
            self.writelist.extend(["Van", "Truck"])
        if self.use_dontcare:
            self.writelist.extend(["DontCare"])

        assert split in ["train", "val", "trainval", "test"]
        split_file = os.path.join(self.root_dir, "ImageSets", split + ".txt")
        with open(split_file) as f:
            self.idx_list = [x.strip() for x in f.readlines()]

        self.data_dir = os.path.join(
            self.root_dir, "testing" if split == "test" else "training"
        )
        self.image_dir = os.path.join(self.data_dir, "image_2")
        self.calib_dir = os.path.join(self.data_dir, "calib")
        self.label_dir = os.path.join(self.data_dir, "label_2")

        self.data_augmentation = split in ["train", "trainval"]
        self.aug_pd = cfg.get("aug_pd", False)
        self.aug_crop = cfg.get("aug_crop", False)
        self.aug_calib = cfg.get("aug_calib", False)
        self.random_flip = cfg.get("random_flip", 0.5)
        self.random_crop = cfg.get("random_crop", 0.5)
        self.scale = cfg.get("scale", 0.4)
        self.shift = cfg.get("shift", 0.1)
        self.depth_scale = cfg.get("depth_scale", "normal")

        self.mean = np.array([0.485, 0.456, 0.406], dtype=np.float32)
        self.std = np.array([0.229, 0.224, 0.225], dtype=np.float32)
        self.cls_mean_size = np.array(
            [
                [1.76255119, 0.66068622, 0.84422524],
                [1.52563191462, 1.62856739989, 3.88311640418],
                [1.73698127, 0.59706367, 1.76282397],
            ]
        )
        if not self.meanshape:
            self.cls_mean_size = np.zeros_like(self.cls_mean_size, dtype=np.float32)

        self.downsample = 32
        self.pd = PhotometricDistort()
        self.clip_2d = cfg.get("clip_2d", False)

    def get_image(self, idx):
        img_file = os.path.join(self.image_dir, "%06d.png" % idx)
        return Image.open(img_file)

    def get_label(self, idx):
        return read_label(os.path.join(self.label_dir, "%06d.txt" % idx))

    def get_calib(self, idx):
        return Calibration(os.path.join(self.calib_dir, "%06d.txt" % idx))

    def eval(self, results_dir, logger):
        """Official KITTI AP eval over written results (kitti_dataset.py:101-116)."""
        from ..eval.kitti_eval import kitti_common as kitti
        from ..eval.kitti_eval.eval import get_official_eval_result

        logger.info("==> Loading detections and GTs...")
        img_ids = [int(i) for i in self.idx_list]
        dt_annos = kitti.get_label_annos(results_dir)
        gt_annos = kitti.get_label_annos(self.label_dir, img_ids)
        test_id = {"Car": 0, "Pedestrian": 1, "Cyclist": 2}
        logger.info("==> Evaluating (official) ...")
        car_moderate = 0
        for category in self.writelist:
            if category not in test_id:
                continue
            results_str, results_dict, mAP3d_R40 = get_official_eval_result(
                gt_annos, dt_annos, test_id[category]
            )
            if category == "Car":
                car_moderate = mAP3d_R40
            logger.info(results_str)
        return car_moderate

    def __len__(self):
        return len(self.idx_list)

    def __getitem__(self, item):
        index = int(self.idx_list[item])
        img = self.get_image(index)
        img_size = np.array(img.size)
        features_size = self.resolution // self.downsample

        center = np.array(img_size) / 2
        crop_size, crop_scale = img_size, 1
        random_flip_flag, random_crop_flag = False, False

        if self.data_augmentation:
            if self.aug_pd:
                img = np.array(img).astype(np.float32)
                img = self.pd(img).astype(np.uint8)
                img = Image.fromarray(img)
            if np.random.random() < self.random_flip:
                random_flip_flag = True
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if self.aug_crop and np.random.random() < self.random_crop:
                random_crop_flag = True
                crop_scale = np.clip(
                    np.random.randn() * self.scale + 1,
                    1 - self.scale, 1 + self.scale,
                )
                crop_size = img_size * crop_scale
                center[0] += img_size[0] * np.clip(
                    np.random.randn() * self.shift, -2 * self.shift, 2 * self.shift
                )
                center[1] += img_size[1] * np.clip(
                    np.random.randn() * self.shift, -2 * self.shift, 2 * self.shift
                )

        trans, trans_inv = get_affine_transform(
            center, crop_size, 0, self.resolution, inv=1
        )
        # fused C++ warp + normalize (releases the GIL -> the threaded
        # loader parallelizes across images)
        img = native.warp_affine_normalize(
            np.asarray(img, np.uint8), trans_inv,
            int(self.resolution[0]), int(self.resolution[1]),
            self.mean, self.std,
        )

        info = {
            "img_id": index,
            "img_size": img_size.astype(np.float32),
            "bbox_downsample_ratio": (img_size / features_size).astype(np.float32),
        }

        if self.split == "test":
            calib = self.get_calib(index)
            return img, calib.P2, self._empty_targets(img_size), info

        labels = self.get_label(index)
        calib = self.get_calib(index)

        if random_flip_flag:
            if self.aug_calib:
                calib.flip(img_size)
            labels.flip_2d(img_size[0], flip_pos=self.aug_calib)

        targets = self._encode_targets(
            labels, calib, trans, img_size, random_flip_flag, crop_scale
        )
        targets["img_size"] = img_size.astype(np.float32)
        return img, calib.P2, targets, info

    def _empty_targets(self, img_size):
        M = self.max_objs
        t = {
            "calibs": np.zeros((M, 3, 4), np.float32),
            "labels": np.zeros((M,), np.int32),
            "boxes": np.zeros((M, 4), np.float32),
            "boxes_3d": np.zeros((M, 6), np.float32),
            "depth": np.zeros((M, 1), np.float32),
            "size_2d": np.zeros((M, 2), np.float32),
            "size_3d": np.zeros((M, 3), np.float32),
            "src_size_3d": np.zeros((M, 3), np.float32),
            "heading_bin": np.zeros((M, 1), np.int32),
            "heading_res": np.zeros((M, 1), np.float32),
            "mask": np.zeros((M,), bool),
            "img_size": img_size.astype(np.float32),
        }
        return t

    def _encode_targets(self, labels, calib, trans, img_size,
                        random_flip_flag, crop_scale):
        """Padded target encoding, vectorized over objects.

        Semantics are the reference's per-object loop
        (kitti_dataset.py:208-305), pinned by tests/test_golden_dataset.py:
        surviving objects keep their ORIGINAL slot index i (filtered slots
        stay zero), and `mask` additionally requires trunc<=0.5 & occ<=2.
        """
        t = self._empty_targets(img_size)
        n = min(len(labels), self.max_objs)
        if n == 0:
            return t
        lab = labels.head(n)
        res = self.resolution.astype(np.float32)

        keep = np.array([c in self.writelist for c in lab.cls], dtype=bool)
        z = lab.pos[:, 2]
        keep &= (lab.level != 4) & (z >= 2) & (z <= 65)

        # one affine matmul for all box corners (float64 like the
        # reference's np.dot(trans_f64, pt))
        bbox_2d = np.concatenate(
            [affine_transform(lab.box2d[:, :2], trans),
             affine_transform(lab.box2d[:, 2:], trans)], axis=1)
        center_2d = (bbox_2d[:, 0:2] + bbox_2d[:, 2:4]) / 2

        # project all 3-D centers at once
        center_3d = lab.pos + np.stack(
            [np.zeros(n, np.float32), -lab.hwl[:, 0] / 2,
             np.zeros(n, np.float32)], axis=1)
        center_3d, _ = calib.rect_to_img(center_3d)
        if random_flip_flag and not self.aug_calib:
            center_3d[:, 0] = img_size[0] - center_3d[:, 0]
        center_3d = affine_transform(center_3d, trans)

        keep &= (center_3d[:, 0] >= 0) & (center_3d[:, 0] < res[0])
        keep &= (center_3d[:, 1] >= 0) & (center_3d[:, 1] < res[1])

        size_2d = np.stack(
            [bbox_2d[:, 2] - bbox_2d[:, 0], bbox_2d[:, 3] - bbox_2d[:, 1]], 1)
        center_2d_norm = center_2d / res
        size_2d_norm = size_2d / res
        corner_2d_norm = bbox_2d / np.concatenate([res, res])
        center_3d_norm = center_3d / res

        lrtb = np.stack(
            [center_3d_norm[:, 0] - corner_2d_norm[:, 0],
             corner_2d_norm[:, 2] - center_3d_norm[:, 0],
             center_3d_norm[:, 1] - corner_2d_norm[:, 1],
             corner_2d_norm[:, 3] - center_3d_norm[:, 1]], axis=1)
        # the reference writes labels/size_2d BEFORE its lrtb>=0 continue
        # (kitti_dataset.py:257-261 vs :274), so objects failing only that
        # check keep their class id and 2-D size
        keep_pre = keep.copy()
        if self.clip_2d:
            lrtb = np.clip(lrtb, 0, 1)
        else:
            keep &= (lrtb >= 0).all(axis=1)

        cls_id = np.array([self.cls2id.get(c, 0) for c in lab.cls], np.int32)

        if self.depth_scale == "normal":
            depth = z * crop_scale
        elif self.depth_scale == "inverse":
            depth = z / crop_scale
        else:  # 'none'
            depth = z

        # heading: ry -> alpha at the (already-flipped) source box center,
        # wrapped twice like ry2alpha + the caller's re-check, then binned
        u = (lab.box2d[:, 0] + lab.box2d[:, 2]) / 2
        heading = calib.ry2alpha(lab.ry, u)
        heading = np.where(heading > np.pi, heading - 2 * np.pi, heading)
        heading = np.where(heading < -np.pi, heading + 2 * np.pi, heading)
        angle_per_class = 2 * np.pi / NUM_HEADING_BIN
        shifted = (heading % (2 * np.pi) + angle_per_class / 2) % (2 * np.pi)
        heading_bin = (shifted / angle_per_class).astype(np.int32)
        heading_res = shifted - (heading_bin * angle_per_class + angle_per_class / 2)

        src_size_3d = lab.hwl.astype(np.float32)
        size_3d = src_size_3d - self.cls_mean_size[cls_id].astype(np.float32)

        k1 = keep[:, None]
        t["labels"][:n] = np.where(keep_pre, cls_id, 0)
        t["size_2d"][:n] = np.where(keep_pre[:, None], size_2d, 0)
        t["boxes"][:n] = np.where(
            k1, np.concatenate([center_2d_norm, size_2d_norm], 1), 0)
        t["boxes_3d"][:n] = np.where(
            k1, np.concatenate([center_3d_norm, lrtb], 1), 0)
        t["depth"][:n, 0] = np.where(keep, depth, 0)
        t["heading_bin"][:n, 0] = np.where(keep, heading_bin, 0)
        t["heading_res"][:n, 0] = np.where(keep, heading_res, 0)
        t["src_size_3d"][:n] = np.where(k1, src_size_3d, 0)
        t["size_3d"][:n] = np.where(k1, size_3d, 0)
        t["mask"][:n] = keep & (lab.truncation <= 0.5) & (lab.occlusion <= 2)
        t["calibs"][:n] = np.where(k1[:, :, None], calib.P2[None], 0)
        return t
