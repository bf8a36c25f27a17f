"""monodetr_torch/ops/losses.py and the auxiliary helpers of
monodetr_torch/ops/utils.py against monodetr_tpu/ops/losses.py and
monodetr_tpu/ops/utils.py on seeded numpy inputs, at 1e-6 relative
(mirroring tests/test_aux_api.py): the seven losses, masked and unmasked
and with both reductions, their gradients where the criterion
backpropagates through them, and the seven helpers (LID depth bins,
heading bins, gaussian radius and patches, the two heatmap painters and
the projected-box drawing)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monodetr_tpu.ops import losses as JL
from monodetr_tpu.ops import utils as JU
from monodetr_torch.ops import losses as L
from monodetr_torch.ops import utils as U

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture
def rng():
    return np.random.RandomState(7)


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("alpha", [0.25, -1.0])
@pytest.mark.parametrize("masked", [False, True])
def test_sigmoid_focal_loss(rng, alpha, masked):
    logits = rng.randn(4, 20, 3).astype(np.float32)
    targets = (rng.rand(4, 20, 3) > 0.8).astype(np.float32)
    qmask = (rng.rand(4, 20) > 0.3).astype(np.float32) if masked else None
    want = JL.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(targets), 9.0, alpha=alpha,
                                 query_mask=None if qmask is None else jnp.asarray(qmask))
    got = L.sigmoid_focal_loss(t(logits), t(targets), 9.0, alpha=alpha,
                               query_mask=None if qmask is None else t(qmask))
    close(got, want)
    # a tensor box count, as the criterion passes it
    close(L.sigmoid_focal_loss(t(logits), t(targets), torch.tensor(9.0), alpha=alpha,
                               query_mask=None if qmask is None else t(qmask)), want)


def test_sigmoid_focal_loss_gradient(rng):
    logits = rng.randn(2, 11, 3).astype(np.float32)
    targets = (rng.rand(2, 11, 3) > 0.7).astype(np.float32)
    want = jax.grad(lambda x: JL.sigmoid_focal_loss(x, jnp.asarray(targets), 5.0))(
        jnp.asarray(logits))
    x = t(logits).requires_grad_()
    L.sigmoid_focal_loss(x, t(targets), 5.0).backward()
    close(x.grad, want, atol=1e-8)


@pytest.mark.parametrize("fn", ["heatmap_focal_loss", "cornernet_focal_loss"])
@pytest.mark.parametrize("positives", [True, False])
def test_heatmap_focal_losses(rng, fn, positives):
    probs = rng.rand(2, 3, 8, 8).astype(np.float32) * 0.98 + 0.01
    target = np.zeros_like(probs)
    if positives:
        target[0, 1, 2, 3] = 1.0
        target[1, 0, 4, 4] = 1.0
        target[1, 0, 4, 5] = 0.6  # near-peak soft value
    want = getattr(JL, fn)(jnp.asarray(probs), jnp.asarray(target))
    got = getattr(L, fn)(t(probs), t(target))
    close(got, want)


@pytest.mark.parametrize("mask_kind", [None, "float", "bool"])
def test_dim_aware_l1_loss(rng, mask_kind):
    pred = rng.randn(6, 3).astype(np.float32)
    target = (rng.rand(6, 3) + 0.5).astype(np.float32)
    dim = (rng.rand(6, 3) + 0.5).astype(np.float32)
    mask = np.array([1, 1, 1, 0, 1, 0], np.float32)[:, None]
    jmask = None if mask_kind is None else jnp.asarray(mask)
    tmask = None if mask_kind is None else (t(mask) if mask_kind == "float" else t(mask > 0))
    want = JL.dim_aware_l1_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(dim),
                                mask=jmask)
    close(L.dim_aware_l1_loss(t(pred), t(target), t(dim), mask=tmask), want)
    # the sum: the mean times the (masked) element count
    n = 18 if mask_kind is None else 12
    close(L.dim_aware_l1_loss(t(pred), t(target), t(dim), mask=tmask, reduction="sum"),
          float(want) * n, rtol=2e-6)
    # the gradient reaches the prediction only (dimension and weight detached)
    jg = jax.grad(lambda p: JL.dim_aware_l1_loss(p, jnp.asarray(target), jnp.asarray(dim),
                                                 mask=jmask))(jnp.asarray(pred))
    p = t(pred).requires_grad_()
    L.dim_aware_l1_loss(p, t(target), t(dim), mask=tmask).backward()
    close(p.grad, jg, atol=1e-8)


def test_masked_losses_ignore_padding(rng):
    """tests/test_aux_api.py:test_masked_losses_ignore_padding on the port."""
    pred = rng.randn(6, 3).astype(np.float32)
    target = (rng.rand(6, 3) + 0.5).astype(np.float32)
    dim = (rng.rand(6, 3) + 0.5).astype(np.float32)
    mask = np.array([1, 1, 1, 0, 0, 0], np.float32)[:, None]
    got = L.dim_aware_l1_loss(t(pred), t(target), t(dim), mask=t(mask))
    want = L.dim_aware_l1_loss(t(pred[:3]), t(target[:3]), t(dim[:3]))
    close(got, want, rtol=1e-5)


@pytest.mark.parametrize("fn", ["laplacian_aleatoric_uncertainty_loss",
                                "gaussian_aleatoric_uncertainty_loss"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("masked", [False, True])
def test_aleatoric_losses(rng, fn, reduction, masked):
    pred = rng.randn(11).astype(np.float32)
    target = rng.randn(11).astype(np.float32)
    logvar = rng.randn(11).astype(np.float32)
    mask = (rng.rand(11) > 0.4).astype(np.float32) if masked else None
    want = getattr(JL, fn)(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(logvar),
                           reduction=reduction, mask=None if mask is None else jnp.asarray(mask))
    got = getattr(L, fn)(t(pred), t(target), t(logvar), reduction=reduction,
                         mask=None if mask is None else t(mask))
    close(got, want)
    if masked:  # a bool mask selects the same elements
        close(getattr(L, fn)(t(pred), t(target), t(logvar), reduction=reduction,
                             mask=t(mask > 0)), want)


def test_bin_depths_lid(rng):
    depth = np.concatenate([rng.rand(50) * 70, [-1.0, 0.0, 60.0, 59.99, np.inf, np.nan]])
    depth = depth.astype(np.float32).reshape(2, 28)
    want = np.asarray(JU.bin_depths_lid(jnp.asarray(depth)))
    got = U.bin_depths_lid(t(depth)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == 80 and got.min() >= 0


def test_angle2class_np(rng):
    for angle in list(rng.uniform(-2 * np.pi, 2 * np.pi, 40)) + [0.0, np.pi, -np.pi,
                                                                  np.pi / 12, 2 * np.pi]:
        want = JU.angle2class_np(angle)
        got = U.angle2class_np(angle)
        assert got[0] == want[0]
        assert got[1] == pytest.approx(want[1], rel=1e-12, abs=1e-12)
        # and class2angle_np inverts it
        assert np.cos(U.class2angle_np(*got)) == pytest.approx(np.cos(angle), abs=1e-9)


@pytest.mark.parametrize("size,overlap", [((24.0, 48.0), 0.7), ((5.0, 3.0), 0.5),
                                          ((120.0, 30.0), 0.9)])
def test_gaussian_radius(size, overlap):
    assert U.gaussian_radius(size, overlap) == JU.gaussian_radius(size, overlap)


@pytest.mark.parametrize("shape,sigma", [((7, 7), 7 / 6), ((5, 9), 1.0), ((1, 1), 0.5)])
def test_gaussian2d(shape, sigma):
    np.testing.assert_array_equal(U.gaussian2d(shape, sigma), JU.gaussian2d(shape, sigma))
    g = U.gaussian2d(shape, sigma)
    assert g[shape[0] // 2, shape[1] // 2] == pytest.approx(1.0)


@pytest.mark.parametrize("center,radius", [((2, 1), 3), ((3, 2), 2), ((-8, -8), 2),
                                           ((11, 9), 4), ((6, 5), 0)])
def test_draw_heatmap_gaussian(center, radius):
    base = np.random.RandomState(3).rand(10, 12).astype(np.float32) * 0.5
    got, want = base.copy(), base.copy()
    out = U.draw_heatmap_gaussian(got, center, radius)
    JU.draw_heatmap_gaussian(want, center, radius)
    assert out is got  # in place
    np.testing.assert_array_equal(got, want)
    assert (got >= base).all()


@pytest.mark.parametrize("center,sigma", [((8, 8), 2), ((1, 14), 1), ((30, 30), 2),
                                          ((-3, 5), 1)])
def test_draw_msra_gaussian(center, sigma):
    got = np.zeros((16, 16), np.float32)
    want = np.zeros((16, 16), np.float32)
    U.draw_msra_gaussian(got, center, sigma)
    JU.draw_msra_gaussian(want, center, sigma)
    np.testing.assert_array_equal(got, want)


def test_draw_projected_box3d(rng):
    corners = (rng.rand(8, 2) * [120, 60]).astype(np.float32)
    got = np.zeros((64, 128, 3), np.uint8)
    want = np.zeros((64, 128, 3), np.uint8)
    out = U.draw_projected_box3d(got, corners, color=(0, 255, 0), thickness=2)
    JU.draw_projected_box3d(want, corners, color=(0, 255, 0), thickness=2)
    assert out is got
    np.testing.assert_array_equal(got, want)
    assert got[..., 1].any() and not got[..., 0].any()
