"""Kernel 1's backward (monodetr_torch/csrc/msda_win.cu:
msda_enc_fused_bwd_weights_kernel, msda_enc_fused_bwd_tiles_kernel,
msda_enc_fused_bwd_softmax_kernel) as a decomposition, on the CPU.

The first pass softmaxes each head's logits as kernel 1's forward does
(common.cuh:quad_softmax: the head's own maximum, thread l of the quad
sums level l's exponentials in order, then 2 shuffles).  The tile pass
walks window_tiles' query slots and decodes each (query, head, level)
(EncSrc): that level's weights, the clamp to +-lim around the query's
static centre, the strict `free` mask.  `decode_model` is that softmax,
walk and decode in numpy, held to the weights and positions of the plain
version (`ops/msda_enc.py:enc_samples`) on every pyramid the port's tests
and smoke run, and two whose level ratios are not powers of two, at G = 6
and 8: positions and masks exact, weights within 1e-6 relative (the plain
softmax sums in another order).

The backward's split, `two_pass_backward`: per-sample weight gradients and
masked offset gradients (the tile pass's outputs), then dlogits = att *
(gatt - sum(att * gatt)) per head (the softmax pass's), held to autograd
through ms_deform_attn_enc_fused_plain (max |a - b| / (1 + max |b|) <=
1e-6, f32), and to the JAX package's kernel-1 gradient, jax.grad through
its interpret-mode Pallas kernel (rtol 2e-3, atol 2e-4, the bounds of
tests/test_msda_enc_fused.py).  The plain version's own gradients are
held to the JAX oracle composition by tests/test_torch_train_ops.py.  The
kernels themselves are held to the plain version on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monodetr_tpu.ops.msda_enc_pallas import ms_deform_attn_enc_fused as jax_fused
from monodetr_torch.ops.msda import ms_deform_attn_px
from monodetr_torch.ops.msda_enc import (enc_samples, ms_deform_attn_enc_fused_plain,
                                         window_limit)
from monodetr_torch.ops.msda_windowed import window_tiles

torch.set_num_threads(2)
H, L, P = 8, 4, 4
SHAPES = ((8, 16), (4, 8), (2, 4), (1, 2))
FULL = ((48, 160), (24, 80), (12, 40), (6, 20))
STRESS = ((96, 320), (48, 160), (24, 80), (12, 40))
DILATED = ((48, 160), (24, 80), (24, 80), (12, 40))  # two levels of one size
ODD = ((12, 40), (6, 20), (3, 10), (2, 5))  # a level ratio of 3/2
ODD_IMAGE = ((47, 156), (24, 78), (12, 39), (6, 20))  # a 376x1248 image's
PYRAMIDS = {"small": SHAPES, "full": FULL, "stress": STRESS, "dilated": DILATED, "odd": ODD,
            "odd_image": ODD_IMAGE}
GRAD_TOL = 1e-6


def n_tokens(shapes):
    return sum(h * w for h, w in shapes)


def offsets(rng, shape, window, kind):
    """Offsets in pixels: 'beyond' some up to 1 px past the window
    (clamped), 'c3' odd multiples of 1/32 px (ROADMAP.md C3), else inside
    the window.  None lies on the clamp bound or an integer position."""
    lim = window_limit(window)
    u = rng.rand(*shape) * 2 - 1
    if kind == "c3":
        return ((np.floor(u * (lim + 1) * 16) * 2 + 1) / 32).astype(np.float32)
    if kind == "beyond":
        return rng.choice([-lim + 0.1, lim - 0.3, 0.05, lim + 0.7, -lim - 1.3],
                          size=shape).astype(np.float32) + (u * 0.04).astype(np.float32)
    return (u * (lim - 0.1)).astype(np.float32)


def inputs(shapes, window, kind="in", B=2, D=8, seed=0):
    rng = np.random.RandomState(seed)
    S = n_tokens(shapes)
    value = rng.randn(B, S, H, D).astype(np.float32)
    off = offsets(rng, (B, S, 2 * H * L * P), window, "c3" if kind == "spread" else kind)
    logits = (rng.randn(B, S, H * L * P) * 2).astype(np.float32)
    if kind == "spread":  # 200 between heads: each head's own maximum (ROADMAP.md C2)
        logits = logits + np.repeat(np.linspace(-100, 100, H, dtype=np.float32), L * P)
    gout = rng.randn(B, S, H * D).astype(np.float32)
    return value, off, logits, gout


def tile_slots(shapes, window):
    """(q, lq, gx, gy): for every filled slot of every tile, the grid query
    the tile pass works on, its level and its pixel there, as
    common.cuh:win_query reads them from the per-tile table (columns, then
    bands of tiles): slot i is level lq's query (qx, qy) of the tile's
    range from (gx0, gy0), filled where qx < n_x and qy < n_y."""
    t = window_tiles(shapes, window)
    table = t.tile_table()
    nx = t.grid[0]
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    out = []
    for i in range(t.queries):
        lq = max(k for k in range(len(shapes)) if t.first[k] <= i)
        qy, qx = divmod(i - t.first[lq], t.tile[lq][0])
        filled = (qx < table[:nx, 1, lq])[None, :] & (qy < table[nx:, 1, lq])[:, None]
        gx = np.broadcast_to(table[:nx, 0, lq][None, :] + qx, filled.shape)[filled]
        gy = np.broadcast_to(table[nx:, 0, lq][:, None] + qy, filled.shape)[filled]
        out.append((starts[lq] + gy * shapes[lq][1] + gx, np.full(gx.shape, lq), gx, gy))
    return tuple(np.concatenate(x) for x in zip(*out))


def decode_model(shapes, window, off, logits):
    """The first pass's weights and EncSrc's decode of every (batch item,
    query, head, level) the tile pass reaches: (att, fx, fy, free_x,
    free_y), each [B, S, H, L, P] (f32, bool), and how often each query was
    reached.  The softmax is kernel 1's quad_softmax (thread l of the quad
    sums level l's 4 exponentials in order, then 2 shuffles); the centre is
    common.cuh:grid_centre's, in f64 and rounded once."""
    B, S = logits.shape[:2]
    lim = np.float32(window_limit(window))
    lg = logits.reshape(B, S, H, L, P)
    m = lg.max(axis=(3, 4), keepdims=True)  # the head's own maximum
    e = np.exp(lg - m, dtype=np.float32)
    s = np.zeros((B, S, H, L), np.float32)
    for u in range(P):
        s = s + e[..., u]
    total = (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])
    att = e / total[..., None, None]
    ox = off[..., :H * L * P].reshape(B, S, H, L, P)
    oy = off[..., H * L * P:].reshape(B, S, H, L, P)
    fx, fy = np.full_like(ox, np.nan), np.full_like(oy, np.nan)
    q, lq, gx, gy = tile_slots(shapes, window)
    hq, wq = (np.array([shapes[k][i] for k in lq]) for i in (0, 1))
    for l, (hl, wl) in enumerate(shapes):
        cx = ((gx + 0.5) * wl / wq - 0.5).astype(np.float32)
        cy = ((gy + 0.5) * hl / hq - 0.5).astype(np.float32)
        cx, cy = cx[None, :, None, None], cy[None, :, None, None]
        fx[:, :, :, l][:, q] = cx + np.clip(ox[:, :, :, l][:, q], -lim, lim)
        fy[:, :, :, l][:, q] = cy + np.clip(oy[:, :, :, l][:, q], -lim, lim)
    return att, fx, fy, np.abs(ox) < lim, np.abs(oy) < lim, np.bincount(q, minlength=S)


@pytest.mark.parametrize("window", [6, 8])
@pytest.mark.parametrize("pyramid", list(PYRAMIDS))
def test_decode_model_equals_the_plain_samples(pyramid, window):
    """Every query is reached once by the tile pass, and its decoded
    weights, positions and masks are the plain version's."""
    shapes = PYRAMIDS[pyramid]
    value, off, logits, _ = inputs(shapes, window, "beyond", B=1, D=1, seed=window)
    att, fx, fy, free_x, free_y, seen = decode_model(shapes, window, off, logits)
    assert (seen == 1).all()
    px, py, pa = (x.numpy() for x in enc_samples(torch.from_numpy(value), shapes,
                                                 torch.from_numpy(off),
                                                 torch.from_numpy(logits), window))
    np.testing.assert_array_equal(fx, px)
    np.testing.assert_array_equal(fy, py)
    np.testing.assert_allclose(att, pa, rtol=1e-6, atol=0)
    lim = np.float32(window_limit(window))
    ox = off[..., :H * L * P].reshape(free_x.shape)
    assert free_x.any() and not free_x.all()
    np.testing.assert_array_equal(free_x, np.clip(ox, -lim, lim) == ox)
    oy = off[..., H * L * P:].reshape(free_y.shape)
    np.testing.assert_array_equal(free_y, np.clip(oy, -lim, lim) == oy)


def two_pass_backward(value, shapes, off, logits, gout, window):
    """The backward as the kernels split it, after the weights: tile pass,
    the per-sample weight gradients gatt and the offset gradients att *
    d sample / d pos, 0 where |offset| >= lim, with dvalue; softmax pass,
    dlogits = att * (gatt - sum over the head of att * gatt)."""
    B, S = logits.shape[:2]
    fx, fy, att = (x.detach().requires_grad_(True)
                   for x in enc_samples(value, shapes, off, logits, window))
    v = value.detach().requires_grad_(True)
    out = ms_deform_attn_px(v, shapes, fx, fy, att)
    gvalue, gfx, gfy, gatt = torch.autograd.grad(out, (v, fx, fy, att), gout)
    lim = torch.tensor(window_limit(window), dtype=torch.float32)
    ox, oy = off.float().split(H * L * P, -1)
    goff = torch.cat([torch.where(ox.abs() < lim, gfx.reshape(ox.shape), 0.0),
                      torch.where(oy.abs() < lim, gfy.reshape(oy.shape), 0.0)], -1)
    a = att.detach().reshape(B, S, H, L * P)
    g = gatt.reshape(B, S, H, L * P)
    glogits = a * (g - (a * g).sum(-1, keepdim=True))
    return gvalue, goff, glogits.reshape(B, S, H * L * P)


def rel_err(got, want):
    return ((got - want).abs().max() / (1 + want.abs().max())).item()


@pytest.mark.parametrize("window", [6, 8])
@pytest.mark.parametrize("kind", ["in", "beyond", "spread", "c3"])
def test_two_pass_backward_equals_autograd_through_the_plain_version(kind, window):
    value, off, logits, gout = (torch.from_numpy(x) for x in inputs(SHAPES, window, kind))
    got = two_pass_backward(value, SHAPES, off, logits, gout, window)
    xs = [x.clone().requires_grad_(True) for x in (value, off, logits)]
    want = torch.autograd.grad(
        ms_deform_attn_enc_fused_plain(xs[0], SHAPES, xs[1], xs[2], window), xs, gout)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert rel_err(a, b) <= GRAD_TOL
    if kind == "beyond":
        assert (got[1] == 0).any() and (got[1] != 0).any()


def jax_grads(fn, value, off, logits, gout):
    def loss(v, o, lg):
        return jnp.vdot(fn(v, o, lg).reshape(gout.shape), gout)

    grads = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(off),
                                              jnp.asarray(logits))
    return [np.asarray(g) for g in grads]


def test_two_pass_backward_equals_the_jax_kernel_gradient():
    """Against jax.grad of the JAX package's ms_deform_attn_enc_fused, whose
    backward is its Pallas kernel (interpret mode on the CPU), at G = 8 with
    offsets beyond the window; B = 1 and 4 channels keep it to ~2 minutes."""
    value, off, logits, gout = inputs(SHAPES, 8, "beyond", B=1, D=4, seed=4)
    got = two_pass_backward(torch.from_numpy(value), SHAPES, torch.from_numpy(off),
                            torch.from_numpy(logits), torch.from_numpy(gout), 8)
    want = jax_grads(lambda v, o, lg: jax_fused(v, SHAPES, o, lg, 8), value, off, logits, gout)
    for name, a, b in zip(("value", "off", "logits"), got, want):
        np.testing.assert_allclose(a.reshape(b.shape).numpy(), b, rtol=2e-3, atol=2e-4,
                                   err_msg=name)
