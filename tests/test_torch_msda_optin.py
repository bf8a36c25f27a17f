"""The opt-in deformable-attention ops of monodetr_torch against the JAX
package, in f32 on the CPU.

- Kernels 5 and 6 (msda_impl 'pallas' and 'sepwin') and 'windowed' compute
  one windowed function.  The interpret-mode Pallas kernels are `slow`
  (tests/test_msda_pallas.py, test_msda_sepwin_pallas.py), so the fast
  cases hold the port's plain versions against
  monodetr_tpu.ops.msda_windowed.ms_deform_attn_windowed, which those JAX
  tests hold equal to both kernels; one `slow` case each runs the
  interpret-mode kernel itself.  Forward and the gradients of value, loc
  (or fx, fy) and attn, with offsets inside and beyond the window, and an
  edge-heavy forward with offsets on the clamp bound.
- Kernel 7 (dec_msda_impl 'dense_fused'): its plain version against the
  interpret-mode Pallas ms_deform_attn_dense_fused and against
  ms_deform_attn_dense, forward and gradients, samples outside the maps.
- The lane helpers, `pack`, the refusals that mirror msda_pallas.py:
  _check_contract, and the seeded offset-bias ring of every impl.

Sample positions are odd multiples of 1/32 px (1/10 px for kernel 7's
non-power-of-two levels) and at least 0.02 px off the clamp bound: at an
integer the one-sided bilinear derivative and the hat's -sign(0) = 0 pick
different sides, and on the bound jnp.clip splits the gradient (ROADMAP.md
C3).  Tolerance: rtol 1e-4, atol 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monodetr_tpu.models.msda_module import MSDeformAttn as JaxMSDA
from monodetr_tpu.ops import msda_pallas as jax_pallas
from monodetr_tpu.ops.msda import ms_deform_attn_dense as jax_dense
from monodetr_tpu.ops.msda_dense_pallas import ms_deform_attn_dense_fused as jax_dense_fused
from monodetr_tpu.ops.msda_windowed import clamp_offsets_to_window as jax_clamp_offsets
from monodetr_tpu.ops.msda_windowed import ms_deform_attn_windowed as jax_windowed
from monodetr_torch.models.msda_module import IMPLS, MSDeformAttn
from monodetr_torch.ops.msda_dense import ms_deform_attn_dense, ms_deform_attn_dense_fused
from monodetr_torch.ops.msda_enc import window_limit
from monodetr_torch.ops.msda_pallas import (center_lane_tables, ms_deform_attn_pallas,
                                            ms_deform_attn_pallas_packed,
                                            ms_deform_attn_pallas_packed_plain,
                                            offset_lane_perm, pack)
from monodetr_torch.ops.msda_sepwin import ms_deform_attn_sepwin
from monodetr_torch.ops.msda_windowed import (clamp_offsets_to_window,
                                              ms_deform_attn_windowed)

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5
SHAPES = ((8, 16), (4, 8), (2, 4), (1, 2))
SEP_SHAPES = ((12, 20), (6, 10), (3, 5), (2, 3))
H, L, P = 8, 4, 4
S = sum(h * w for h, w in SHAPES)

LOC_OPS = {"pallas": ms_deform_attn_pallas, "sepwin": ms_deform_attn_sepwin,
           "windowed": ms_deform_attn_windowed}


def grid_refs(shapes):
    """[S, 2] normalised centres of every level's pixels, level-major."""
    refs = []
    for h, w in shapes:
        ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
        refs.append(np.stack([xs / w, ys / h], -1).reshape(-1, 2))
    return np.concatenate(refs, 0).astype(np.float32)


def norm():
    return np.array([[w, h] for h, w in SHAPES], np.float32)


def windowed_inputs(rng, window, kind, B=2, D=4):
    """(value, loc, attn) for grid queries.  Offsets in pixels: 'inside'
    within the window, 'beyond' up to 3 px past it (clamped), both odd
    multiples of 1/32 (the centres are multiples of 1/16 at levels that
    halve, so no position is an integer, and none is within 0.02 px of the
    bound); 'edge' exactly -lim, 0 or +lim (for the forward)."""
    lim = window_limit(window)
    shape = (B, S, H, L, P, 2)
    if kind == "edge":
        off = rng.choice([-lim, lim, 0.0], size=shape)
    else:
        reach = lim - 0.05 if kind == "inside" else lim + 3
        off = (np.floor((rng.rand(*shape) * 2 - 1) * reach * 16) * 2 + 1) / 32
    loc = grid_refs(SHAPES)[None, :, None, None, None] + off / norm()[:, None]
    value = rng.randn(B, S, H, D).astype(np.float32)
    attn = rng.rand(B, S, H, L, P).astype(np.float32)
    attn /= attn.sum((-2, -1), keepdims=True)
    return value, loc.astype(np.float32), attn, off


def grads(fn, inputs, g):
    """(output, gradients of <g, fn(*inputs)>) through the port."""
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    out = fn(*xs)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in xs]


def jax_grads(fn, inputs, g):
    """(output, gradients of <g, fn(*inputs)>) through JAX, compiled as one
    program (op-by-op dispatch of the windowed op takes minutes)."""
    def fwd_bwd(*args):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(jnp.asarray(g).reshape(out.shape))

    out, gs = jax.jit(fwd_bwd)(*inputs)
    return np.asarray(out), [np.asarray(x) for x in gs]


def close(got, want):
    np.testing.assert_allclose(got, np.asarray(want).reshape(got.shape), rtol=RTOL, atol=ATOL)


def test_offset_lane_perm_matches_jax():
    for hlp in ((8, 4, 4), (4, 2, 3)):
        np.testing.assert_array_equal(offset_lane_perm(*hlp), jax_pallas.offset_lane_perm(*hlp))


@pytest.mark.parametrize("shapes", [SHAPES, ((48, 160), (24, 80), (12, 40), (6, 20))])
def test_center_lane_tables_match_jax(shapes):
    for got, want in zip(center_lane_tables(shapes), jax_pallas.center_lane_tables(shapes)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_clamp_offsets_to_window_matches_jax():
    x = np.random.RandomState(0).randn(3, 50).astype(np.float32) * 4
    for window in (6, 8):
        np.testing.assert_array_equal(clamp_offsets_to_window(torch.from_numpy(x), window).numpy(),
                                      np.asarray(jax_clamp_offsets(x, window)))


@pytest.mark.parametrize("window", [6, 8])
def test_pack_matches_jax(window):
    value, loc, attn, _ = windowed_inputs(np.random.RandomState(window), window, "beyond")
    got = pack(SHAPES, torch.from_numpy(loc), torch.from_numpy(attn), window)
    want = jax_pallas._pack(SHAPES, jnp.asarray(loc), jnp.asarray(attn), window)
    for a, b in zip(got, want):
        assert a.shape == (2, S, 128) and a.dtype == torch.float32
        close(a.numpy(), b)


# (kind, window) of the windowed cases: XLA compiles the JAX windowed
# op's gradient in ~15 s at G = 6, so each reference is computed once
WINDOWED_CASES = {"inside": 6, "beyond": 4}


@functools.lru_cache(maxsize=None)
def windowed_reference(kind):
    """(inputs (value, loc, attn), offsets, g, JAX output, JAX gradients)."""
    window = WINDOWED_CASES[kind]
    rng = np.random.RandomState(window)
    value, loc, attn, off = windowed_inputs(rng, window, kind)
    g = rng.randn(2, S, H * value.shape[-1]).astype(np.float32)
    want, want_g = jax_grads(lambda *x: jax_windowed(x[0], SHAPES, x[1], x[2], window),
                             (value, loc, attn), g)
    return (value, loc, attn), off, g, want, want_g


@pytest.mark.parametrize("op", sorted(LOC_OPS))
@pytest.mark.parametrize("kind", sorted(WINDOWED_CASES))
def test_windowed_ops_match_jax_windowed(op, kind):
    """Forward and the gradients of value, loc and attn against jax.vjp of
    ms_deform_attn_windowed."""
    window = WINDOWED_CASES[kind]
    inputs, off, g, want, want_g = windowed_reference(kind)
    got, got_g = grads(lambda *x: LOC_OPS[op](x[0], SHAPES, x[1], x[2], window), inputs, g)
    close(got, want)
    for a, b in zip(got_g, want_g):
        close(a, b)
    clamped = np.abs(off) > window_limit(window)
    assert clamped.any() == (kind == "beyond")
    assert (got_g[1][clamped] == 0).all()  # a clamped position has no location gradient


@pytest.mark.parametrize("op", sorted(LOC_OPS))
def test_windowed_ops_edge_heavy_forward(op):
    """Offsets exactly on the clamp bound or at 0, as in
    tests/test_msda_pallas.py: forward only (the gradient at the bound is
    measure-zero and the two packages differ there)."""
    value, loc, attn, _ = windowed_inputs(np.random.RandomState(7), 4, "edge")
    got = LOC_OPS[op](torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
                      torch.from_numpy(attn), 4)
    close(got.numpy(), jax.jit(lambda *x: jax_windowed(x[0], SHAPES, x[1], x[2], 4))(
        value, loc, attn))


def lanes(x):
    """[B, S, H, L, P] -> [B, S, 128] in lane order (lv, h, p), as
    msda_pallas.py:_pack packs, in numpy."""
    return np.transpose(x, (0, 1, 3, 2, 4)).reshape(x.shape[0], x.shape[1], -1)


def test_packed_op_matches_jax_windowed():
    """The packed entry, on the lane-packed pixel positions of the 'inside'
    case (no clamp), against ms_deform_attn_windowed: forward, and the
    gradients of value, att and fx, fy (= the location gradient / (w, h))
    packed in the JAX lane order."""
    (value, loc, attn), _, g, want, (gv, gloc, gattn) = windowed_reference("inside")
    fx, fy, att = pack(SHAPES, torch.from_numpy(loc), torch.from_numpy(attn), 6)
    gf = gloc / norm()[:, None]
    want_g = (gv, lanes(gf[..., 0]), lanes(gf[..., 1]), lanes(gattn))
    for op in (ms_deform_attn_pallas_packed, ms_deform_attn_pallas_packed_plain):
        got, got_g = grads(lambda *x: op(x[0], SHAPES, *x[1:], 6),
                           (value, fx.numpy(), fy.numpy(), att.numpy()), g)
        close(got, want)
        for a, b in zip(got_g, want_g):
            close(a, b)


@pytest.mark.slow
@pytest.mark.parametrize("op", ["pallas", "sepwin"])
def test_windowed_plain_matches_interpret_kernel(op):
    """The port's CPU path against the interpret-mode Pallas kernel."""
    if op == "pallas":
        from monodetr_tpu.ops.msda_pallas import ms_deform_attn_pallas as kernel
    else:
        from monodetr_tpu.ops.msda_sepwin_pallas import ms_deform_attn_sepwin as kernel
    rng = np.random.RandomState(9)
    value, loc, attn, _ = windowed_inputs(rng, 8, "beyond", B=1)
    g = rng.randn(1, S, H * value.shape[-1]).astype(np.float32)
    got, got_g = grads(lambda *x: LOC_OPS[op](x[0], SHAPES, x[1], x[2], 8), (value, loc, attn), g)
    want, want_g = jax_grads(lambda *x: kernel(x[0], SHAPES, x[1], x[2], 8),
                             (value, loc, attn), g)
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=2e-3, atol=2e-4)
    for a, b in zip(got_g, want_g):  # the kernels' own tolerance against windowed
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-4)


def dense_inputs(rng, B=2, Hd=4, D=8, Q=37):
    """Locations whose pixel positions lie in [-4.5, size + 2.5], at least
    0.1 px off any integer: some samples fall wholly or partly outside."""
    Sd = sum(h * w for h, w in SEP_SHAPES)
    wh = np.array([[w, h] for h, w in SEP_SHAPES], np.float32)[:, None]
    u = rng.rand(B, Q, Hd, L, P, 2)
    px = np.floor(u * (wh + 7) - 5) + 0.5 + (rng.rand(*u.shape) - 0.5) * 0.8
    loc = ((px + 0.5) / wh).astype(np.float32)
    value = rng.randn(B, Sd, Hd, D).astype(np.float32)
    att = rng.rand(B, Q, Hd, L, P).astype(np.float32)
    att /= att.sum((-2, -1), keepdims=True)
    return value, loc, att


@pytest.mark.parametrize("reference", ["dense_fused_interpret", "dense"])
def test_dense_plain_matches_jax(reference):
    """Kernel 7's plain version (and the CPU path of its wrapper): forward
    and the three gradients against the interpret-mode Pallas kernel and
    against the XLA dense op."""
    rng = np.random.RandomState(11)
    value, loc, att = dense_inputs(rng)
    assert ((loc < 0) | (loc > 1)).any()
    g = rng.randn(2, loc.shape[1], 4 * 8).astype(np.float32)
    ref = jax_dense_fused if reference == "dense_fused_interpret" else jax_dense
    want, want_g = jax_grads(lambda *x: ref(x[0], SEP_SHAPES, x[1], x[2]), (value, loc, att), g)
    for op in (ms_deform_attn_dense, ms_deform_attn_dense_fused):
        got, got_g = grads(lambda *x: op(x[0], SEP_SHAPES, x[1], x[2]), (value, loc, att), g)
        close(got, want)
        for a, b in zip(got_g, want_g):
            close(a, b)


def refusal_case(op, fault):
    """Inputs that break one clause of the windowed contract."""
    shapes, Hq, Pq, Q = SHAPES, H, P, S
    if fault == "not_grid":
        Q = S - 1
    elif fault == "ratio":
        shapes = ((8, 16), (4, 8), (2, 4), (1, 3))
    elif fault == "heads":
        Hq = 4
    else:  # points
        Pq = 2
    Sv = sum(h * w for h, w in shapes)
    value = torch.zeros(1, Sv, Hq, 4)
    loc = torch.full((1, Q, Hq, L, Pq, 2), 0.5)
    attn = torch.full((1, Q, Hq, L, Pq), 1.0 / (L * Pq))
    return lambda: LOC_OPS[op](value, shapes, loc, attn, 8)


@pytest.mark.parametrize("op,fault", [(op, f) for op in ("pallas", "sepwin")
                                      for f in ("not_grid", "ratio", "heads", "points")]
                         + [("windowed", "not_grid"), ("windowed", "ratio")])
def test_windowed_ops_refuse_what_their_contract_excludes(op, fault):
    with pytest.raises(ValueError):
        refusal_case(op, fault)()


def test_windowed_impls_refuse_non_grid_queries():
    for impl in ("fused", "pallas", "sepwin", "windowed"):
        m = MSDeformAttn(impl=impl, window=6)
        with pytest.raises(ValueError, match="grid queries"):
            m(torch.zeros(1, 5, 256), torch.zeros(1, 5, L, 2), torch.zeros(1, S, 256), SHAPES)
        with pytest.raises(ValueError, match="grid queries"):
            m(torch.zeros(1, S, 256), torch.zeros(1, S, L, 6), torch.zeros(1, S, 256), SHAPES)


@pytest.mark.parametrize("impl", IMPLS)
def test_offset_ring_matches_jax(impl):
    """The seeded sampling_offsets.bias of every impl equals the one the
    JAX module initialises: the windowed impls shrink the ring to 0.75 of
    the window's reach, the exact ones keep the reference radii."""
    m = MSDeformAttn(impl=impl, window=6)
    m.init_offset_bias()
    spec = jax.ShapeDtypeStruct
    variables = JaxMSDA(impl=impl, window=6).lazy_init(
        jax.random.PRNGKey(0), spec((1, S, 256), jnp.float32),
        spec((1, S, L, 2), jnp.float32), spec((1, S, 256), jnp.float32), SHAPES)
    want = np.asarray(variables["params"]["sampling_offsets"]["bias"])
    np.testing.assert_array_equal(m.sampling_offsets.bias.detach().numpy(), want)
    reach = np.abs(want).max()
    assert reach == (1.5 if impl in ("fused", "pallas", "sepwin", "windowed") else P)


def test_profile_groups_name_each_msda_kernel():
    """profile_train files every MSDA kernel under its own group: the
    opt-in kernels' names contain the default ones' ("msda_sepwin" holds
    "msda_sep"), so the order of the groups decides."""
    from monodetr_torch.profile_train import group_of

    want = {"msda_enc_fused_kernel": "kernel 1", "msda_enc_fused_bwd_weights_kernel": "kernel 1",
            "msda_enc_fused_bwd_tiles_kernel": "kernel 1",
            "msda_enc_fused_bwd_softmax_kernel": "kernel 1",
            "msda_sep_kernel": "kernel 2", "msda_sep_bwd_kernel": "kernel 2",
            "msda_pallas_kernel": "kernel 5", "msda_pallas_bwd_kernel": "kernel 5",
            "msda_sepwin_kernel": "kernel 6", "msda_sepwin_bwd_kernel": "kernel 6",
            "msda_dense_fused_kernel": "kernel 7",
            "msda_dense_fused_bwd_value_kernel": "kernel 7",
            "msda_dense_fused_bwd_bin_kernel": "kernel 7"}
    for name, kernel in want.items():
        group = group_of(f"void mdt::{name}<__nv_bfloat16>(__nv_bfloat16 const*, int)")
        assert kernel in group and ("bwd" in name) == ("bwd" in group), (name, group)
    groups = {group_of(f"void mdt::msda_dense_fused_bwd_{part}_kernel<float>()")
              for part in ("bin", "value")}
    assert len(groups) == 2  # kernel 7's binning and value side are read apart
