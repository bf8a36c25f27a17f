"""The two deformable-attention kernels' plain versions against the JAX
package.

Kernel 1, ms_deform_attn_enc_fused: its plain version is held against the
JAX oracle composition of tests/test_msda_enc_fused.py (per-head softmax ->
clip -> ms_deform_attn_windowed), and in one slow case against the
interpret-mode Pallas kernel itself.  Kernel 2, ms_deform_attn_sep: its
plain version (ops/msda.py) is held against the interpret-mode Pallas
ms_deform_attn_sep and against ms_deform_attn_reference, with samples
outside the maps.  Inputs stay off the clamp edge and off integer-aligned
positions (ROADMAP.md C3).  Tolerance in f32: rtol 1e-4, atol 1e-5.  The
kernels against their plain versions on the card: tests/test_torch_cuda.py.
Every kernel wrapper, the opt-in ones of tests/test_torch_msda_optin.py
included, counts only kernel launches and refuses a device that is neither
the CPU nor a CUDA card.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monodetr_tpu.ops.msda import ms_deform_attn_reference
from monodetr_tpu.ops.msda_pallas import _center_positions
from monodetr_tpu.ops.msda_sep_pallas import ms_deform_attn_sep as jax_msda_sep
from monodetr_tpu.ops.msda_windowed import ms_deform_attn_windowed
from monodetr_torch.models.transformer import encoder_reference_points
from monodetr_torch.ops.msda_dense import ms_deform_attn_dense_fused
from monodetr_torch.ops.msda_enc import ms_deform_attn_enc_fused, window_limit
from monodetr_torch.ops.msda_pallas import ms_deform_attn_pallas, ms_deform_attn_pallas_packed
from monodetr_torch.ops.msda_sep import ms_deform_attn_sep
from monodetr_torch.ops.msda_sepwin import ms_deform_attn_sepwin
from monodetr_torch.utils import trace

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5
ENC_SHAPES = ((8, 16), (4, 8), (2, 4), (1, 2))
SEP_SHAPES = ((12, 20), (6, 10), (3, 5), (2, 3))
H, L, P = 8, 4, 4


def n_tokens(shapes):
    return sum(h * w for h, w in shapes)


@functools.partial(jax.jit, static_argnums=3)
def _enc_oracle(value, off, logits, window, shapes=ENC_SHAPES):
    """tests/test_msda_enc_fused.py:oracle: softmax -> clip -> windowed."""
    B, S = off.shape[:2]
    att = jax.nn.softmax(logits.reshape(B, S, H, L * P), -1).reshape(B, S, H, L, P)
    lim = window_limit(window)
    offc = jnp.clip(off, -lim, lim)
    ox = offc[..., :128].reshape(B, S, H, L, P)
    oy = offc[..., 128:].reshape(B, S, H, L, P)
    c = _center_positions(shapes)
    fx = c[None, :, None, :, None, 0] + ox
    fy = c[None, :, None, :, None, 1] + oy
    sizes = jnp.asarray([[w, h] for h, w in shapes], jnp.float32)
    loc = jnp.stack([(fx + 0.5) / sizes[None, None, None, :, None, 0],
                     (fy + 0.5) / sizes[None, None, None, :, None, 1]], -1)
    return ms_deform_attn_windowed(value, shapes, loc, att, window)


def enc_oracle(value, off, logits, window):
    return np.asarray(_enc_oracle(jnp.asarray(value), jnp.asarray(off), jnp.asarray(logits),
                                  window))


def enc_inputs(rng, window, B=2, D=4, beyond=False, logit_scale=0.7):
    S = n_tokens(ENC_SHAPES)
    value = rng.randn(B, S, H, D).astype(np.float32)
    lim = window_limit(window)
    if beyond:  # in-window and far-out offsets; none on the edge or at 0
        off = rng.choice([-lim + 0.1, lim - 0.1, 0.05, lim + 1.7, -lim - 2.3],
                         size=(B, S, 256)).astype(np.float32)
    else:
        off = ((rng.rand(B, S, 256) * 2 - 1) * (lim - 0.1)).astype(np.float32)
    logits = (rng.randn(B, S, 128) * logit_scale).astype(np.float32)
    return value, off, logits


@pytest.mark.parametrize("window,beyond", [(6, False), (6, True), (8, False), (8, True)])
def test_enc_fused_plain_matches_oracle(window, beyond):
    rng = np.random.RandomState(10 * window + beyond)
    value, off, logits = enc_inputs(rng, window, beyond=beyond)
    got = ms_deform_attn_enc_fused(torch.from_numpy(value), ENC_SHAPES, torch.from_numpy(off),
                                   torch.from_numpy(logits), window)
    np.testing.assert_allclose(got.numpy(), enc_oracle(value, off, logits, window),
                               rtol=RTOL, atol=ATOL)


def test_enc_fused_large_logit_spread_between_heads():
    """Each head's softmax subtracts its own maximum (ROADMAP.md C2): with
    a spread of ~200 between heads the result stays finite and equal to the
    oracle, where a shared 128-lane row maximum would underflow a head."""
    rng = np.random.RandomState(11)
    value, off, logits = enc_inputs(rng, 6)
    logits = logits + np.repeat(np.linspace(-100, 100, H, dtype=np.float32), L * P)
    got = ms_deform_attn_enc_fused(torch.from_numpy(value), ENC_SHAPES, torch.from_numpy(off),
                                   torch.from_numpy(logits), 6).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, enc_oracle(value, off, logits, 6), rtol=RTOL, atol=ATOL)


@pytest.mark.slow
def test_enc_fused_plain_matches_pallas_kernel():
    from monodetr_tpu.ops.msda_enc_pallas import ms_deform_attn_enc_fused as jax_fused

    rng = np.random.RandomState(12)
    value, off, logits = enc_inputs(rng, 8, beyond=True)
    want = np.asarray(jax_fused(jnp.asarray(value), ENC_SHAPES, jnp.asarray(off),
                                jnp.asarray(logits), 8))
    got = ms_deform_attn_enc_fused(torch.from_numpy(value), ENC_SHAPES, torch.from_numpy(off),
                                   torch.from_numpy(logits), 8).numpy()
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=RTOL, atol=ATOL)


def sep_inputs(rng, B=2, D=8, Q=37, oob=False):
    S = n_tokens(SEP_SHAPES)
    value = rng.randn(B, S, H, D).astype(np.float32)
    loc = rng.rand(B, Q, H, L, P, 2).astype(np.float32)
    if oob:
        loc = loc * 2.0 - 0.5  # beyond [0, 1] on both sides
    att = rng.rand(B, Q, H, L, P).astype(np.float32)
    att /= att.sum(axis=(-2, -1), keepdims=True)
    return value, loc, att


@pytest.mark.parametrize("oob", [False, True])
def test_sep_plain_matches_pallas_and_reference(oob):
    rng = np.random.RandomState(20 + oob)
    value, loc, att = sep_inputs(rng, oob=oob)
    got = ms_deform_attn_sep(torch.from_numpy(value), SEP_SHAPES, torch.from_numpy(loc),
                             torch.from_numpy(att)).numpy()
    args = (jnp.asarray(value), SEP_SHAPES, jnp.asarray(loc), jnp.asarray(att))
    np.testing.assert_allclose(got, np.asarray(jax_msda_sep(*args)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(ms_deform_attn_reference(*args)),
                               rtol=RTOL, atol=ATOL)


def test_wrappers_count_only_kernel_launches():
    """On the CPU the wrappers, forward and backward, run the plain
    versions and count nothing."""
    rng = np.random.RandomState(30)
    counters = ("msda_enc_fused", "msda_enc_fused_bwd", "msda_sep", "msda_sep_bwd",
                "msda_dense_fused", "msda_dense_fused_bwd", "msda_pallas", "msda_pallas_bwd",
                "msda_sepwin", "msda_sepwin_bwd")
    before = [trace.counts().get(name, 0) for name in counters]
    value, loc, att = (torch.from_numpy(x).requires_grad_(True) for x in sep_inputs(rng))
    for op in (ms_deform_attn_sep, ms_deform_attn_dense_fused):
        op(value, SEP_SHAPES, loc, att).sum().backward()
    value, off, logits = (torch.from_numpy(x).requires_grad_(True)
                          for x in enc_inputs(rng, 6))
    ms_deform_attn_enc_fused(value, ENC_SHAPES, off, logits, 6).sum().backward()
    S = n_tokens(ENC_SHAPES)
    grid = torch.from_numpy(encoder_reference_points(ENC_SHAPES))[None, :, None, None, None]
    loc = (grid + torch.rand(2, S, H, L, P, 2) * 0.01).requires_grad_(True)
    att = torch.full((2, S, H, L, P), 1.0 / (L * P), requires_grad=True)
    ms_deform_attn_sepwin(value, ENC_SHAPES, loc, att, 6).sum().backward()
    ms_deform_attn_pallas(value, ENC_SHAPES, loc, att, 6).sum().backward()
    assert [trace.counts().get(name, 0) for name in counters] == before


@pytest.mark.parametrize("which", ["enc", "sep", "pallas", "sepwin", "dense_fused"])
def test_wrappers_never_fall_back_off_the_cpu(which):
    """A tensor that is on neither the CPU nor a CUDA card is refused, not
    handed to the plain version."""
    meta = torch.device("meta")
    S = n_tokens(ENC_SHAPES)
    value = torch.empty(1, S, H, 32, device=meta)
    loc = torch.empty(1, S, H, L, P, 2, device=meta)
    att = torch.empty(1, S, H, L, P, device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        if which == "enc":
            ms_deform_attn_enc_fused(value, ENC_SHAPES, torch.empty(1, S, 256, device=meta),
                                     torch.empty(1, S, 128, device=meta), 6)
        elif which == "pallas":
            lanes = [torch.empty(1, S, 128, device=meta) for _ in range(3)]
            ms_deform_attn_pallas_packed(value, ENC_SHAPES, *lanes, 6)
        elif which == "sepwin":
            ms_deform_attn_sepwin(value, ENC_SHAPES, loc, att, 6)
        else:
            op = ms_deform_attn_sep if which == "sep" else ms_deform_attn_dense_fused
            op(value, ENC_SHAPES, loc[:, :5], att[:, :5])
