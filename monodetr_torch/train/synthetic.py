"""Synthetic training batches, made from a seed with numpy (no image
files): normalised images at the shipped 384x1280 or any other size
(768x2560 for the stress configuration), KITTI P2
matrices whose focal length and principal point vary a little, and padded
targets with 1-8 objects per image whose 2-D and 6-D boxes agree.  Used by
chip_smoke.py and monodetr_torch.profile_train on the card."""

import numpy as np


def make_targets(rng, B, T=50, max_objects=8):
    """Padded numpy targets of B images with 1..max_objects objects each:
    2-D boxes (cxcywh) and 6-D boxes (3-D centre inside the 2-D box,
    distances to its edges) that agree, depth, size, heading bin and
    residual, and the mask."""
    x1 = rng.rand(B, T) * 0.7
    y1 = rng.rand(B, T) * 0.5 + 0.2
    x2 = x1 + rng.rand(B, T) * 0.25 + 0.02
    y2 = y1 + rng.rand(B, T) * 0.2 + 0.02
    cx = x1 + (x2 - x1) * (rng.rand(B, T) * 0.6 + 0.2)
    cy = y1 + (y2 - y1) * (rng.rand(B, T) * 0.6 + 0.2)
    mask = np.arange(T)[None] < rng.randint(1, max_objects + 1, (B, 1))
    f = np.float32
    m = mask[..., None]
    return {
        "labels": (rng.randint(0, 3, (B, T)) * mask).astype(np.int64),
        "boxes": (np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1) * m).astype(f),
        "boxes_3d": (np.stack([cx, cy, cx - x1, x2 - cx, cy - y1, y2 - cy], -1) * m).astype(f),
        "depth": ((rng.rand(B, T, 1) * 50 + 3) * m).astype(f),
        "size_3d": ((rng.rand(B, T, 3) * np.array([0.5, 0.4, 1.5]) + [1.4, 1.5, 3.4]) * m)
        .astype(f),
        "heading_bin": (rng.randint(0, 12, (B, T, 1)) * m).astype(np.int64),
        "heading_res": (rng.randn(B, T, 1) * 0.2 * m).astype(f),
        "mask": mask,
    }


class SyntheticLoader:
    """`n_batches` batches of `batch` normalised height x width images from
    a seed, each with a KITTI P2 whose focal length and principal point vary
    a little, in the loader's (batch, infos) format, with training targets."""

    def __init__(self, n_batches, batch, seed, height=384, width=1280):
        self.n_batches, self.batch, self.seed = n_batches, batch, seed
        self.height, self.width = height, width
        # meanshape: False in the shipped config -> zero mean sizes
        self.dataset = type("Dataset", (), {"cls_mean_size": np.zeros((3, 3), np.float32)})

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        p2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                       [0.0, 721.5377, 172.854, 0.2163791],
                       [0.0, 0.0, 1.0, 0.002745884]], np.float32)
        for b in range(self.n_batches):
            n = self.batch
            calibs = np.repeat(p2[None], n, 0)
            calibs[:, 0, 0] = calibs[:, 1, 1] = 700 + 40 * rng.random(n, np.float32)
            calibs[:, :2, 2] += rng.normal(0, 5, (n, 2)).astype(np.float32)
            images = rng.standard_normal((n, self.height, self.width, 3), np.float32)
            sizes = np.tile(np.array([[1242.0, 375.0]], np.float32), (n, 1))
            infos = [{"img_id": b * n + i, "img_size": sizes[i]} for i in range(n)]
            batch = {"images": images, "calibs": calibs, "img_sizes": sizes}
            batch.update(make_targets(np.random.RandomState(self.seed * 1000 + b), n))
            yield batch, infos
