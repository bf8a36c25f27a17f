"""The monodetr_torch CUDA kernels against their plain PyTorch versions, on
a CUDA card (every test is marked `cuda` and skips without one).  This
file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances (max |kernel - plain|): 2e-4 in f32 (summation order, and the
plain MSDA re-normalising pixel positions for grid_sample), 3e-2 in bf16
(outputs rounded to bf16 at values of order 1).
"""

import numpy as np
import pytest
import torch

from monodetr_torch.models.monodetr import build_monodetr
from monodetr_torch.ops.attention import attention_plain, fused_attention
from monodetr_torch.ops.msda import ms_deform_attn
from monodetr_torch.ops.msda_enc import (ms_deform_attn_enc_fused,
                                         ms_deform_attn_enc_fused_plain, window_limit)
from monodetr_torch.ops.msda_sep import ms_deform_attn_sep

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)
H, L, P, D = 8, 4, 4, 32
SHAPES = ((8, 16), (4, 8), (2, 4), (1, 2))
FULL_SHAPES = ((48, 160), (24, 80), (12, 40), (6, 20))
DTYPES = [(torch.float32, 2e-4), (torch.bfloat16, 3e-2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def max_err(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shapes,window", [(SHAPES, 6), (SHAPES, 8), (FULL_SHAPES, 6)])
def test_enc_fused_kernel(cuda, dtype, tol, shapes, window):
    rng = np.random.RandomState(window)
    S = sum(h * w for h, w in shapes)
    lim = window_limit(window)
    value = torch.from_numpy(rng.randn(1, S, H, D).astype(np.float32)).to(cuda, dtype)
    off = torch.from_numpy(rng.choice([-lim + 0.1, lim - 0.3, 0.05, lim + 1.7, -lim - 2.3],
                                      size=(1, S, 256)).astype(np.float32)
                           + rng.rand(1, S, 256).astype(np.float32) * 0.1).to(cuda, dtype)
    logits = torch.from_numpy(rng.randn(1, S, 128).astype(np.float32) * 2).to(cuda, dtype)
    got = ms_deform_attn_enc_fused(value, shapes, off, logits, window)
    want = ms_deform_attn_enc_fused_plain(value, shapes, off, logits, window)
    assert max_err(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("q", [1, 50, 550])
def test_sep_kernel(cuda, dtype, tol, q):
    rng = np.random.RandomState(q)
    S = sum(h * w for h, w in FULL_SHAPES)
    value = torch.from_numpy(rng.randn(2, S, H, D).astype(np.float32)).to(cuda, dtype)
    loc = torch.from_numpy(rng.rand(2, q, H, L, P, 2).astype(np.float32) * 1.4 - 0.2).to(cuda)
    att = torch.softmax(torch.from_numpy(rng.randn(2, q, H, L * P).astype(np.float32)), -1)
    att = att.view(2, q, H, L, P).to(cuda)
    got = ms_deform_attn_sep(value, FULL_SHAPES, loc, att)
    want = ms_deform_attn(value, FULL_SHAPES, loc, att)
    assert max_err(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("tq,tk", [(1920, 1920), (50, 1920), (130, 70), (1, 1)])
def test_attention_kernel(cuda, dtype, tol, tq, tk):
    g = torch.Generator(device=cuda).manual_seed(tq + tk)
    q = torch.randn(2, H, tq, D, generator=g, device=cuda).to(dtype)
    k = torch.randn(2, H, tk, D, generator=g, device=cuda).to(dtype)
    v = torch.randn(2, H, tk, D, generator=g, device=cuda).to(dtype)
    got = fused_attention(q, k, v, 0, D ** -0.5, 0.0)
    assert max_err(got, attention_plain(q, k, v, D ** -0.5)) <= tol


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, H, 64, D, device=cuda)
    with pytest.raises(TypeError):
        fused_attention(q, q.bfloat16(), q, 0, 1.0, 0.0)
    with pytest.raises(ValueError):
        fused_attention(q.transpose(2, 3), q, q, 0, 1.0, 0.0)
    with pytest.raises(ValueError):
        fused_attention(q, q.cpu(), q, 0, 1.0, 0.0)


def test_model_forward_through_kernels(cuda):
    """A 2+2-layer model at 384x1280 in f32: the kernels against the plain
    versions, and one launch of each kernel per layer that runs it."""
    model = build_monodetr(dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep",
                                enc_layers=2, dec_layers=2), seed=0).to(cuda)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(2, 384, 1280, 3).astype(np.float32)).to(cuda)
    calibs = torch.tensor([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                          device=cuda).expand(2, 3, 4)
    sizes = torch.tensor([[1242.0, 375.0]], device=cuda).expand(2, 2)
    counters = (ms_deform_attn_enc_fused, ms_deform_attn_sep, fused_attention)
    before = [f.launches for f in counters]
    with torch.no_grad():
        got = model(images, calibs, sizes)
        assert [f.launches - b for f, b in zip(counters, before)] == [2, 2, 1]
        want = model.use_plain_ops(True)(images, calibs, sizes)
    assert [f.launches - b for f, b in zip(counters, before)] == [2, 2, 1]
    for k in ("pred_boxes", "pred_depth", "pred_logits", "weighted_depth"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-3)
