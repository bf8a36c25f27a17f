"""monodetr_torch matching and losses against monodetr_tpu.models, in f32 on
the CPU, on the same numpy outputs and padded targets.

- matching_cost against the JAX matching_cost (rtol 1e-5, atol 1e-4 on
  costs of order 10), and hungarian_match's indices equal to the JAX
  matcher's (its XLA solver on the CPU), with targets scattered among the
  padding so that the valid-first sort and its inverse matter;
- every loss, the aux keys and the weighted total against SetCriterion
  (rtol 1e-5, atol 1e-6), at 11 groups of 50 queries and at a small size;
- bin_depths in its three modes, equal bins.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monodetr_tpu.models.criterion import SetCriterion as JaxCriterion
from monodetr_tpu.models.matcher import hungarian_match as jax_hungarian_match
from monodetr_tpu.models.matcher import matching_cost as jax_matching_cost
from monodetr_tpu.ops.utils import bin_depths as jax_bin_depths
from monodetr_torch.models.criterion import SetCriterion
from monodetr_torch.models.matcher import hungarian_match, matching_cost
from monodetr_torch.ops.utils import bin_depths

torch.set_num_threads(2)


def make_targets(rng, B, T, n_valid):
    """Padded targets [B, T] with n_valid[b] objects at random slots:
    consistent 2-D boxes (cxcywh), 6-D boxes (3-D centre inside the 2-D
    box, distances to its edges), depth, size, heading bin and residual."""
    x1 = rng.rand(B, T) * 0.7
    y1 = rng.rand(B, T) * 0.6 + 0.1
    x2 = x1 + rng.rand(B, T) * 0.25 + 0.03
    y2 = y1 + rng.rand(B, T) * 0.25 + 0.03
    cx = x1 + (x2 - x1) * (rng.rand(B, T) * 0.6 + 0.2)
    cy = y1 + (y2 - y1) * (rng.rand(B, T) * 0.6 + 0.2)
    mask = np.zeros((B, T), bool)
    for b, n in enumerate(n_valid):
        mask[b, rng.choice(T, n, replace=False)] = True
    f = np.float32
    return {
        "labels": (rng.randint(0, 3, (B, T)) * mask).astype(np.int32),
        "boxes": (np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)
                  * mask[..., None]).astype(f),
        "boxes_3d": (np.stack([cx, cy, cx - x1, x2 - cx, cy - y1, y2 - cy], -1)
                     * mask[..., None]).astype(f),
        "depth": ((rng.rand(B, T, 1) * 50 + 3) * mask[..., None]).astype(f),
        "size_3d": ((rng.rand(B, T, 3) * 2 + 0.5) * mask[..., None]).astype(f),
        "heading_bin": (rng.randint(0, 12, (B, T, 1)) * mask[..., None]).astype(np.int64),
        "heading_res": (rng.randn(B, T, 1) * 0.2 * mask[..., None]).astype(f),
        "mask": mask,
    }


def make_outputs(rng, B, QG, n_layers, depth_map_hw=(6, 20)):
    def layer():
        return {
            "pred_logits": (rng.randn(B, QG, 3) * 2).astype(np.float32),
            "pred_boxes": np.concatenate([rng.rand(B, QG, 2) * 0.9 + 0.05,
                                          rng.rand(B, QG, 4) * 0.2 + 0.02], -1).astype(np.float32),
            "pred_3d_dim": (rng.rand(B, QG, 3) * 2 + 0.5).astype(np.float32),
            "pred_depth": np.stack([rng.rand(B, QG) * 50 + 1, rng.randn(B, QG) * 0.3],
                                   -1).astype(np.float32),
            "pred_angle": rng.randn(B, QG, 24).astype(np.float32),
        }

    out = layer()
    out["aux_outputs"] = [layer() for _ in range(n_layers - 1)]
    out["pred_depth_map_logits"] = rng.randn(B, *depth_map_hw, 81).astype(np.float32)
    return out


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    return jnp.asarray(tree)


def test_matching_cost_matches_jax():
    rng = np.random.RandomState(0)
    out = make_outputs(rng, 1, 50, 1)
    tgt = make_targets(rng, 1, 50, (9,))
    args = (out["pred_logits"][0], out["pred_boxes"][0], tgt["labels"][0],
            tgt["boxes_3d"][0], tgt["mask"][0])
    want = jax_matching_cost(*(jnp.asarray(a) for a in args))
    got = matching_cost(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    assert (got.numpy()[:, ~tgt["mask"][0]] == 1e6).all()


@pytest.mark.parametrize("n_valid", [(7, 0), (1, 50), (23, 4)])
def test_hungarian_match_matches_jax(n_valid):
    rng = np.random.RandomState(sum(n_valid))
    out = make_outputs(rng, 2, 11 * 50, 2)
    tgt = make_targets(rng, 2, 50, n_valid)
    layers = [out["aux_outputs"][0], out]
    got = hungarian_match(torch.stack([torch.from_numpy(x["pred_logits"]) for x in layers]),
                          torch.stack([torch.from_numpy(x["pred_boxes"]) for x in layers]),
                          to_torch(tgt), group_num=11)
    for i, layer in enumerate(layers):
        want = jax_hungarian_match(to_jax({k: layer[k] for k in ("pred_logits", "pred_boxes")}),
                                   to_jax(tgt), group_num=11, impl="xla")
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("B,G,NQ,T,n_layers,n_valid", [
    (2, 11, 50, 50, 3, (6, 1)),
    (2, 2, 6, 5, 2, (3, 0)),
])
def test_losses_match_jax(B, G, NQ, T, n_layers, n_valid):
    rng = np.random.RandomState(G)
    out = make_outputs(rng, B, G * NQ, n_layers)
    tgt = make_targets(rng, B, T, n_valid)
    cfg = {"num_classes": 3, "dec_layers": n_layers, "group_num": G}
    want = JaxCriterion(cfg)(to_jax(out), to_jax(tgt), train=True)
    want["total"] = JaxCriterion(cfg).total(want)
    crit = SetCriterion(cfg)
    got = crit(to_torch(out), to_torch(tgt), train=True)
    got["total"] = crit.total(got)
    assert sorted(got) == sorted(want) and len(got) == 2 + 7 * n_layers + 1
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["UD", "LID", "SID"])
def test_bin_depths_matches_jax(mode):
    rng = np.random.RandomState(1)
    d = (rng.rand(4000) * 70 - 5).astype(np.float32)
    d[:3] = [np.nan, np.inf, 0.0]
    np.testing.assert_array_equal(bin_depths(torch.from_numpy(d), mode).numpy(),
                                  np.asarray(jax_bin_depths(jnp.asarray(d), mode)))
