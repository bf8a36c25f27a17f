"""SSD-style augmentation suite (host-side numpy).

`PhotometricDistort` — the only transform the shipped KITTI pipeline uses
(kitti_dataset.py:134-136) — has parity with lib/datasets/kitti/pd.py:376-397:
random brightness, then either [contrast -> HSV saturation/hue] or
[HSV saturation/hue -> contrast], then random channel swap.  cv2 HSV
conversions, float32 pixel math, same probability structure (each step fires
with p=0.5 through numpy's global RandomState — the dataset seeds it).

The rest of the reference's SSD chain (pd.py:9-374,400-416: box-aware
crop/expand/mirror, coordinate conversions, the composed `SSDAugmentation`)
is dead code there — nothing in the KITTI recipe constructs it — and is
deliberately not reproduced here.
"""

import cv2
import numpy as np
from numpy import random

PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def _random_contrast(image, lower=0.5, upper=1.5):
    if random.randint(2):
        image *= random.uniform(lower, upper)
    return image


def _random_saturation(image, lower=0.5, upper=1.5):
    if random.randint(2):
        image[:, :, 1] *= random.uniform(lower, upper)
    return image


def _random_hue(image, delta=18.0):
    if random.randint(2):
        image[:, :, 0] += random.uniform(-delta, delta)
        image[:, :, 0][image[:, :, 0] > 360.0] -= 360.0
        image[:, :, 0][image[:, :, 0] < 0.0] += 360.0
    return image


def _random_brightness(image, delta=32.0):
    if random.randint(2):
        image += random.uniform(-delta, delta)
    return image


def _random_lighting_noise(image):
    if random.randint(2):
        swap = PERMS[random.randint(len(PERMS))]
        image = image[:, :, swap]
    return image


class PhotometricDistort:
    def __call__(self, image):
        im = image.copy()
        im = _random_brightness(im)
        contrast_first = bool(random.randint(2))
        if contrast_first:
            im = _random_contrast(im)
        im = cv2.cvtColor(im, cv2.COLOR_BGR2HSV)
        im = _random_saturation(im)
        im = _random_hue(im)
        im = cv2.cvtColor(im, cv2.COLOR_HSV2BGR)
        if not contrast_first:
            im = _random_contrast(im)
        return _random_lighting_noise(im)
