"""The general generator: inputs of every traffic mix from a seed.

One seed gives the same inputs in every run.  Images are normal draws at
the normalised scale, made on the card by a generator of their own; the
camera matrices and targets come from numpy's generator of the same seed.
A mix file (mixes/<name>.json) fixes `kind` (train: a closed loop of
training steps; stream: one frame in flight) and the sizes below; the
configuration fixes the image size.

Targets: each image holds valid objects padded to `target_slots`.  How
many is the mix's `objects` {mean, shape, min, max}: the pool's images get
the mid-quantiles of `min` plus a negative binomial of the rest of the
mean, capped at `max`, so that every seed has the same set of counts, in
its own order.  Classes 0..2 (Pedestrian, Car, Cyclist) are drawn in the
shares of the mix's `class_counts`; 2-D boxes and 6-D boxes agree (the
3-D centre inside the 2-D box), depth 3-53 m, sizes around a car's,
heading bin and residual.
"""

import math

import numpy as np
import torch

P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
               [0.0, 721.5377, 172.854, 0.2163791],
               [0.0, 0.0, 1.0, 0.002745884]], np.float32)
IMG_SIZE = (1242.0, 375.0)


def sub_seeds(seed, n=4):
    """n independent 63-bit seeds from any whole number."""
    ss = np.random.SeedSequence(int(seed) % 2 ** 64)
    return [int(s) & (2 ** 63 - 1) for s in ss.generate_state(n, np.uint64)]


def object_counts(n, objects):
    """n per-image object counts, ascending: the mid-quantiles of
    objects["min"] + a negative binomial of mean objects["mean"] -
    objects["min"] and shape objects["shape"], capped at objects["max"]."""
    lo, hi, r = objects["min"], objects["max"], float(objects["shape"])
    p = r / (r + objects["mean"] - lo)
    k = np.arange(hi - lo + 1)
    log_pmf = np.array([math.lgamma(x + r) - math.lgamma(r) - math.lgamma(x + 1) for x in k]) \
        + r * math.log(p) + k * math.log1p(-p)
    cdf = np.cumsum(np.exp(log_pmf))
    cdf[-1] = 1.0  # the cap takes the tail
    return lo + np.searchsorted(cdf, (np.arange(n) + 0.5) / n)


def targets(rng, B, slots, objects, class_counts):
    x1 = rng.random((B, slots)) * 0.7
    y1 = rng.random((B, slots)) * 0.5 + 0.2
    x2 = x1 + rng.random((B, slots)) * 0.25 + 0.02
    y2 = y1 + rng.random((B, slots)) * 0.2 + 0.02
    cx = x1 + (x2 - x1) * (rng.random((B, slots)) * 0.6 + 0.2)
    cy = y1 + (y2 - y1) * (rng.random((B, slots)) * 0.6 + 0.2)
    mask = np.arange(slots)[None] < rng.permutation(object_counts(B, objects))[:, None]
    shares = np.asarray(class_counts, float) / np.sum(class_counts)
    f, m = np.float32, mask[..., None]
    return {
        "labels": (rng.choice(3, (B, slots), p=shares) * mask).astype(np.int64),
        "boxes": (np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1) * m).astype(f),
        "boxes_3d": (np.stack([cx, cy, cx - x1, x2 - cx, cy - y1, y2 - cy], -1) * m).astype(f),
        "depth": ((rng.random((B, slots, 1)) * 50 + 3) * m).astype(f),
        "size_3d": ((rng.random((B, slots, 3)) * np.array([0.5, 0.4, 1.5]) + [1.4, 1.5, 3.4])
                    * m).astype(f),
        "heading_bin": (rng.integers(0, 12, (B, slots, 1)) * m).astype(np.int64),
        "heading_res": (rng.standard_normal((B, slots, 1)) * 0.2 * m).astype(f),
        "mask": mask,
    }


def cameras(rng, B):
    calibs = np.repeat(P2[None], B, 0)
    calibs[:, 0, 0] = calibs[:, 1, 1] = 700 + 40 * rng.random(B).astype(np.float32)
    calibs[:, :2, 2] += rng.normal(0, 5, (B, 2)).astype(np.float32)
    sizes = np.tile(np.array([IMG_SIZE], np.float32), (B, 1))
    return calibs, sizes


class Traffic:
    """The inputs of one run: `batches(device)` for training (a pool of
    dicts of device tensors) or `frames()` for inference (a pool of numpy
    batches with their infos)."""

    def __init__(self, mix, config, image_seed, host_seed):
        self.mix = mix
        self.height, self.width = config["input"]["height"], config["input"]["width"]
        self.image_seed, self.host_seed = image_seed, host_seed

    def _images(self, n, device):
        gen = torch.Generator(device).manual_seed(self.image_seed)
        return torch.randn(n, self.height, self.width, 3, generator=gen, device=device)

    def batches(self, device):
        """The training pool, made anew."""
        mix = self.mix
        B, n = mix["batch"], mix["pool"]
        rng = np.random.default_rng(self.host_seed)
        calibs, sizes = cameras(rng, B * n)
        tg = targets(rng, B * n, mix["target_slots"], mix["objects"], mix["class_counts"])
        images = self._images(B * n, device)
        pool = []
        for i in range(n):
            sl = slice(i * B, (i + 1) * B)
            batch = {"images": images[sl], "calibs": calibs[sl], "img_sizes": sizes[sl]}
            batch.update({k: v[sl] for k, v in tg.items()})
            pool.append({k: torch.as_tensor(v).to(device) for k, v in batch.items()})
        return pool

    def calibration_frame(self, device):
        """(images [1, H, W, 3], calibs, img_sizes) of one more frame of the
        mix's kind, made from the seed, that the weights' class bias is set
        on."""
        gen = torch.Generator(device).manual_seed(self.image_seed ^ 0x5A5A5A5A)
        image = torch.randn(1, self.height, self.width, 3, generator=gen, device=device)
        calibs, sizes = cameras(np.random.default_rng(self.host_seed ^ 0x5A5A5A5A), 1)
        return image, torch.from_numpy(calibs).to(device), torch.from_numpy(sizes).to(device)

    def frames(self, device):
        """[(numpy batch {images, calibs, img_sizes}, infos)] of the pool
        (`pool` batches of `batch` images), the images made on `device` and
        copied to the host."""
        mix = self.mix
        B, n = mix["batch"], mix["pool"]
        rng = np.random.default_rng(self.host_seed)
        calibs, sizes = cameras(rng, B * n)
        images = self._images(B * n, device).cpu().numpy()
        out = []
        for i in range(n):
            sl = slice(i * B, (i + 1) * B)
            infos = [{"img_id": i * B + j, "img_size": sizes[i * B + j]} for j in range(B)]
            out.append(({"images": images[sl], "calibs": calibs[sl], "img_sizes": sizes[sl]},
                        infos))
        return out
