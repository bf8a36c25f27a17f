"""monodetr_torch numeric primitives against monodetr_tpu on the same
inputs (made with numpy from a seed).  f32 tolerance: rtol 1e-4,
atol 1e-5 unless stated."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monodetr_tpu.models.position_encoding import sine_pos_table as jax_sine_pos_table
from monodetr_tpu.ops import box_ops as jax_box_ops
from monodetr_tpu.ops import utils as jax_utils
from monodetr_tpu.ops.msda_enc_pallas import offset_feature_perm as jax_offset_perm
from monodetr_tpu.ops.msda_pallas import _center_positions
from monodetr_torch import _build
from monodetr_torch.models.backbone import FrozenBatchNorm2d, conv_bn
from monodetr_torch.models.position_encoding import sine_pos_table
from monodetr_torch.ops import box_ops, utils
from monodetr_torch.ops.msda_enc import grid_centers, offset_feature_perm

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_inverse_sigmoid():
    x = np.concatenate([np.random.RandomState(0).rand(100), [0.0, 1.0, 1e-7, 1 - 1e-7]])
    x = x.astype(np.float32)
    close(utils.inverse_sigmoid(torch.from_numpy(x)), jax_utils.inverse_sigmoid(jnp.asarray(x)))


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_bilinear(align_corners):
    rng = np.random.RandomState(1)
    img = rng.randn(2, 5, 7, 3).astype(np.float32)
    coords = (rng.rand(2, 4, 6, 2) * 2.4 - 1.2).astype(np.float32)  # some outside
    got = utils.grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(coords),
                                     align_corners=align_corners)
    want = jax.vmap(lambda i, c: jax_utils.grid_sample_bilinear(
        i, c, align_corners=align_corners))(jnp.asarray(img), jnp.asarray(coords))
    close(got, want)


def test_lid_bins_and_sine_table():
    np.testing.assert_array_equal(utils.lid_bin_values(80, 1e-3, 60.0),
                                  jax_utils.lid_bin_values(80, 1e-3, 60.0))
    close(sine_pos_table(6, 20, 256), jax_sine_pos_table(6, 20, 256))


def test_interpolate_1d_embed():
    rng = np.random.RandomState(2)
    table = rng.randn(61, 8).astype(np.float32)
    coord = np.concatenate([rng.rand(50) * 60, [0.0, 59.5, 60.0]]).astype(np.float32)
    close(utils.interpolate_1d_embed(torch.from_numpy(coord), torch.from_numpy(table)),
          jax_utils.interpolate_1d_embed(jnp.asarray(coord), jnp.asarray(table)))


@pytest.mark.parametrize("cls,res", [(0, 0.1), (5, -0.2), (7, 0.3), (11, 0.25)])
def test_class2angle(cls, res):
    for label in (False, True):
        assert utils.class2angle_np(cls, res, label) == jax_utils.class2angle_np(cls, res, label)


def test_box_ops():
    b = np.random.RandomState(3).rand(4, 5, 6).astype(np.float32)
    xyxy = box_ops.box_cxcylrtb_to_xyxy(torch.from_numpy(b))
    close(xyxy, jax_box_ops.box_cxcylrtb_to_xyxy(jnp.asarray(b)))
    close(box_ops.box_xyxy_to_cxcywh(xyxy),
          jax_box_ops.box_xyxy_to_cxcywh(jnp.asarray(xyxy.numpy())))


def test_offset_perm_and_grid_centers():
    np.testing.assert_array_equal(offset_feature_perm(), jax_offset_perm())
    for shapes in (((8, 16), (4, 8), (2, 4), (1, 2)), ((48, 160), (24, 80), (12, 40), (6, 20))):
        close(grid_centers(shapes), _center_positions(shapes), rtol=0, atol=1e-6)


def test_conv_with_frozen_bn_folded_in():
    """conv_bn applies the conv, then the affine the four reference buffers
    define: scale = w / sqrt(rv + eps), bias = b - rm * scale (what
    convert_checkpoint folds for JAX)."""
    rng = np.random.RandomState(4)
    bn = FrozenBatchNorm2d(8)
    w, b, rm = rng.rand(8) + 0.5, rng.randn(8), rng.randn(8) * 0.1
    rv = rng.rand(8) + 0.5
    for name, val in zip(("weight", "bias", "running_mean", "running_var"), (w, b, rm, rv)):
        getattr(bn, name).copy_(torch.from_numpy(val.astype(np.float32)))
    conv = torch.nn.Conv2d(5, 8, 3, stride=2, padding=1, bias=False)
    x = torch.from_numpy(rng.randn(2, 5, 7, 9).astype(np.float32))
    scale = w / np.sqrt(rv + 1e-5)
    with torch.no_grad():
        want = (conv(x).numpy() * scale[None, :, None, None]
                + (b - rm * scale)[None, :, None, None])
        close(conv_bn(conv, bn, x), want)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc on PATH, under $CUDA_HOME or at the default path: the build
    raises a clear error before writing anything."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()
