"""The monodetr_torch CUDA kernels against their plain PyTorch versions, on
a CUDA card (every test is marked `cuda` and skips without one).  This
file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances (max |kernel - plain|): 2e-4 in f32 (summation order, and the
plain MSDA re-normalising pixel positions for grid_sample), 3e-2 in bf16
(outputs rounded to bf16 at values of order 1).  Gradients are compared as
max |a - b| / (1 + max |b|): 1e-4 in f32 (the value gradients are summed by
atomics in another order), 3e-2 in bf16.  The LAP kernel is bit-identical
to its plain version.  The backwards of kernels 1, 5 and 6 sum their
value gradient per tile of queries in shared memory and add each staged
row to device memory by atomics, so it repeats from run to run to 1e-6 of
its maximum, not bit for bit; kernel 1's is also held at G = 8, with
every sample at its window's bound, and to its refusals.  Kernels 5-7 (the opt-in MSDA impls 'pallas',
'sepwin' and 'dense_fused') are held to the same bounds, and kernel 7's
value gradient, written without atomics, is bit-identical from run to run.
Kernels 2 and 7 are also held to their plain version at 32 samples per head,
at batches of 1 and 3, on and beyond a level's border, at positions no
int32 holds, with zero weights, with every sample in one pixel, and on a
level of more tiles than kernel 7's binning sorts at a time; a pyramid whose
tokens pass 32-bit offsets is refused.  The query variants' forwards run
the kernels as the standard model's does, and a data-parallel step of two
gloo ranks sharing the card equals one process's step on their images.
Under CUDA's bf16 autocast every norm and layer output of each path is
bf16, as the JAX model's.  The eval step's CUDA graph replays the eager
step's detections bit for bit, in f32 and under bf16 autocast, and sees
weights loaded in place, a cleared table cache and moved parameters.
"""

import contextlib

import numpy as np
import pytest
import torch


from monodetr_torch.models.monodetr import build_monodetr
from monodetr_torch.models.transformer import encoder_reference_points
from monodetr_torch.ops.attention import (attention_keep_mask, attention_plain,
                                          fused_attention, fused_attention_bwd)
from monodetr_torch.ops.lap import lap_edge_cases, lap_solve, lap_solve_plain
from monodetr_torch.ops.msda import ms_deform_attn
from monodetr_torch.ops.msda_enc import (ms_deform_attn_enc_fused, ms_deform_attn_enc_fused_bwd,
                                         ms_deform_attn_enc_fused_plain, window_limit)
from monodetr_torch.ops.msda_dense import (ms_deform_attn_dense, ms_deform_attn_dense_fused,
                                           ms_deform_attn_dense_fused_bwd)
from monodetr_torch.ops.msda_pallas import (ms_deform_attn_pallas_packed,
                                            ms_deform_attn_pallas_packed_bwd,
                                            ms_deform_attn_pallas_packed_plain, pack, to_lanes)
from monodetr_torch.ops.msda_sep import fits_int32, ms_deform_attn_sep, ms_deform_attn_sep_bwd
from monodetr_torch.ops.msda_sepwin import ms_deform_attn_sepwin, ms_deform_attn_sepwin_bwd
from monodetr_torch.ops.msda_windowed import (backward_occupancy, ms_deform_attn_windowed,
                                              window_tiles)
from monodetr_torch.utils import trace

pytestmark = pytest.mark.cuda
torch.set_num_threads(2)
H, L, P, D = 8, 4, 4, 32
SHAPES = ((8, 16), (4, 8), (2, 4), (1, 2))
FULL_SHAPES = ((48, 160), (24, 80), (12, 40), (6, 20))
# the stress configuration's pyramid (768x2560), and the dilated backbone's
# at 384x1280: its last two levels are equal
STRESS_SHAPES = ((96, 320), (48, 160), (24, 80), (12, 40))
DILATED_SHAPES = ((48, 160), (24, 80), (24, 80), (12, 40))
# a 376x1248 image's pyramid: level ratios that are not powers of two
ODD_SHAPES = ((47, 156), (24, 78), (12, 39), (6, 20))
DTYPES = [(torch.float32, 2e-4), (torch.bfloat16, 3e-2)]
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# each kernel wrapper's launch counter (utils/trace.py)
COUNTER = {
    ms_deform_attn_enc_fused: "msda_enc_fused", ms_deform_attn_enc_fused_bwd: "msda_enc_fused_bwd",
    ms_deform_attn_sep: "msda_sep", ms_deform_attn_sep_bwd: "msda_sep_bwd",
    fused_attention: "attention_fwd", fused_attention_bwd: "attention_bwd", lap_solve: "lap",
    ms_deform_attn_pallas_packed: "msda_pallas",
    ms_deform_attn_pallas_packed_bwd: "msda_pallas_bwd",
    ms_deform_attn_sepwin: "msda_sepwin", ms_deform_attn_sepwin_bwd: "msda_sepwin_bwd",
    ms_deform_attn_dense_fused: "msda_dense_fused",
    ms_deform_attn_dense_fused_bwd: "msda_dense_fused_bwd",
}


def launches(fn):
    """The launches so far of the kernel behind the wrapper `fn`."""
    return trace.counts().get(COUNTER[fn], 0)


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
@pytest.mark.parametrize("shapes,window", [(SHAPES, 6), (SHAPES, 8), (FULL_SHAPES, 6),
                                           (STRESS_SHAPES, 6), (DILATED_SHAPES, 6)])
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
    S = sum(h * w for h, w in SHAPES)  # kernel 1 takes at most 16 samples per head
    value = torch.zeros(1, S, H, D, device=cuda)
    with pytest.raises(ValueError):
        ms_deform_attn_enc_fused(value, SHAPES, torch.zeros(1, S, 2 * H * L * 8, device=cuda),
                                 torch.zeros(1, S, H * L * 8, device=cuda), 6)


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
    before = [launches(f) for f in counters]
    with torch.no_grad():
        got = model(images, calibs, sizes)
        assert [launches(f) - b for f, b in zip(counters, before)] == [2, 2, 1]
        want = model.use_plain_ops(True)(images, calibs, sizes)
    assert [launches(f) - b for f, b in zip(counters, before)] == [2, 2, 1]
    for k in ("pred_boxes", "pred_depth", "pred_logits", "weighted_depth"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("enc,dec", [("pallas", "dense_fused"), ("sepwin", "sep")])
def test_model_forward_through_optin_kernels(cuda, enc, dec):
    """The opt-in configurations A (pallas + dense_fused) and B (sepwin +
    sep) as test_model_forward_through_kernels checks the default."""
    model = build_monodetr(dict(msda_impl=enc, msda_window=6, dec_msda_impl=dec,
                                enc_layers=2, dec_layers=2), seed=0).to(cuda)
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.randn(2, 384, 1280, 3).astype(np.float32)).to(cuda)
    calibs = torch.tensor([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                          device=cuda).expand(2, 3, 4)
    sizes = torch.tensor([[1242.0, 375.0]], device=cuda).expand(2, 2)
    counters = ({"pallas": ms_deform_attn_pallas_packed, "sepwin": ms_deform_attn_sepwin}[enc],
                {"dense_fused": ms_deform_attn_dense_fused, "sep": ms_deform_attn_sep}[dec],
                fused_attention)
    before = [launches(f) for f in counters]
    with torch.no_grad():
        got = model(images, calibs, sizes)
        want = model.use_plain_ops(True)(images, calibs, sizes)
    assert [launches(f) - b for f, b in zip(counters, before)] == [2, 2, 1]
    for k in ("pred_boxes", "pred_depth", "pred_logits", "weighted_depth"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("variant", ["two_stage", "use_dab", "two_stage_dino"])
def test_query_variant_forward_through_kernels(cuda, variant):
    """Each query variant (2+2 layers, 128x256, B=2, f32) through the
    kernels against the plain versions, two_stage's encoder outputs too,
    and one launch of each MSDA kernel per layer."""
    kw = {"two_stage": dict(two_stage=True, group_num=1), "use_dab": dict(use_dab=True),
          "two_stage_dino": dict(two_stage_dino=True)}[variant]
    model = build_monodetr(dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep",
                                enc_layers=2, dec_layers=2, **kw), seed=0).to(cuda)
    rng = np.random.RandomState(2)
    images = torch.from_numpy(rng.randn(2, 128, 256, 3).astype(np.float32)).to(cuda)
    calibs = torch.tensor([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                          device=cuda).expand(2, 3, 4)
    sizes = torch.tensor([[1242.0, 375.0]], device=cuda).expand(2, 2)
    counters = (ms_deform_attn_enc_fused, ms_deform_attn_sep)
    before = [launches(f) for f in counters]
    with torch.no_grad():
        got = model(images, calibs, sizes)
        want = model.use_plain_ops(True)(images, calibs, sizes)
    assert [launches(f) - b for f, b in zip(counters, before)] == [2, 2]
    assert got["pred_logits"].shape == (2, 50, 3)
    for k in ("pred_boxes", "pred_depth", "pred_logits", "weighted_depth"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-3, atol=1e-3)
    assert ("enc_outputs" in got) == (variant == "two_stage")
    for k in got.get("enc_outputs", {}):
        torch.testing.assert_close(got["enc_outputs"][k], want["enc_outputs"][k], rtol=1e-3,
                                   atol=1e-3)


# the model options of the paths whose bf16 dtype map is held on the card
# (tests/test_torch_bf16_policy.py holds the same map to the JAX model's)
POLICY_PATHS = {
    "default": dict(msda_impl="fused", dec_msda_impl="sep"),
    "A": dict(msda_impl="pallas", dec_msda_impl="dense_fused"),
    "B": dict(msda_impl="sepwin", dec_msda_impl="sep"),
    "stress": dict(msda_impl="fused", dec_msda_impl="sep", backbone="resnet101", dilation=True,
                   position_embedding="learned", remat=True),
    "two_stage": dict(msda_impl="fused", dec_msda_impl="sep", two_stage=True, group_num=1),
    "use_dab": dict(msda_impl="fused", dec_msda_impl="sep", use_dab=True),
    "two_stage_dino": dict(msda_impl="fused", dec_msda_impl="sep", two_stage_dino=True),
}


@pytest.mark.parametrize("path", list(POLICY_PATHS))
@pytest.mark.parametrize("train", [False, True])
def test_bf16_dtype_map_under_cuda_autocast(cuda, path, train):
    """A 1+1-layer model at 128x256, f32 parameters under CUDA's bf16
    autocast (whose f32 list holds layer_norm and group_norm), the eval
    forward and the training forward with dropout (gradients on, so remat
    runs): every LayerNorm and GroupNorm output and every encoder, decoder
    and depth-encoder layer output is bf16, as the JAX model's at `dtype:
    bf16`; the heads' outputs, the depth map and the proposals' stay f32."""
    from monodetr_torch.models.layers import policy_modules, recorded_output_dtypes

    model = build_monodetr(dict(msda_window=6, enc_layers=1, dec_layers=1,
                                **POLICY_PATHS[path]), seed=0).to(cuda)
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randn(2, 128, 256, 3).astype(np.float32)).to(cuda)
    calibs = torch.tensor([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                          device=cuda).expand(2, 3, 4)
    sizes = torch.tensor([[1242.0, 375.0]], device=cuda).expand(2, 2)
    gen = torch.Generator(device=cuda).manual_seed(0) if train else None
    with recorded_output_dtypes(model) as seen, torch.autocast("cuda", dtype=torch.bfloat16):
        out = model(images, calibs, sizes, train=train, gen=gen)
    f32_norms = ("enc_output_norm", "pos_trans_norm")
    assert set(seen) == {n for n in policy_modules(model) if not n.endswith(f32_norms)}
    wrong = {n: d for n, d in seen.items() if d != {torch.bfloat16}}
    assert not wrong, f"{len(wrong)} of {len(seen)} modules not bf16: {wrong}"
    for k in ("pred_logits", "pred_boxes", "pred_3d_dim", "pred_depth", "pred_angle",
              "pred_depth_map_logits", "weighted_depth"):
        assert out[k].dtype == torch.float32, k
    for k, v in out.get("enc_outputs", {}).items():
        assert v.dtype == torch.float32, k


def test_two_gloo_ranks_on_the_card_equal_one_process(cuda):
    """parallel/dryrun.py:compare_with_one_process on cuda:0: two gloo
    ranks with 2 images each (128x256, 2+2 layers, f32, no dropout) against
    one process on the 4, as tests/test_torch_parallel.py holds it on the
    CPU (detections to 1e-4: cuDNN picks its algorithms by batch size)."""
    from monodetr_torch.parallel.dryrun import compare_with_one_process

    r = compare_with_one_process(2, "cuda:0", "gloo", 128, 256, 2, 2, 2, timeout=600)
    assert r["backend"] == "gloo" and r["device"] == "cuda:0"
    assert r["loss_err"] <= 1e-5 and r["grad_err"] <= 1.0 and r["n_grads"] > 100
    assert r["param_err"] <= 1e-5 and r["moved_share"] <= 1e-3
    assert r["n_equal"] == 2
    assert r["dets_shape"] == [4, 50, 37] and r["dets_err"] <= 1e-4
    assert r["launches"]["msda_enc_fused"] == 2 and r["launches"]["msda_sep_bwd"] == 2
    assert r["launches"]["lap"] == 1


def window_case(shapes, B, dtype, seed, window=6):
    """((value, loc, attn), gout) for grid queries: offsets odd multiples of
    1/32 px, some up to 1 px beyond the window (clamped), so that every
    sample sits >= 1/32 px from an integer and >= 0.02 px from the bound."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    S = sum(h * w for h, w in shapes)
    lim = window_limit(window)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device="cuda")
    grid = torch.from_numpy(encoder_reference_points(shapes)).cuda()[None, :, None, None, None]
    off = (torch.rand(B, S, H, L, P, 2, generator=g, device="cuda") * 2 - 1) * (lim + 1)
    loc = grid + (torch.floor(off * 16) * 2 + 1) / 32 / wh[:, None]
    value = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    att = torch.softmax(torch.randn(B, S, H, L * P, generator=g, device="cuda"), -1)
    gout = torch.randn(B, S, H * D, generator=g, device="cuda")
    return (value, loc, att.view(B, S, H, L, P)), gout


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shapes", [SHAPES, FULL_SHAPES])
def test_windowed_kernels(cuda, dtype, tol, shapes):
    """Kernel 5 (packed) and kernel 6 (sepwin) forward against their plain
    versions."""
    (value, loc, att), _ = window_case(shapes, 2, dtype, 4)
    fx, fy, lanes = pack(shapes, loc, att, 6)
    before = [launches(ms_deform_attn_pallas_packed), launches(ms_deform_attn_sepwin)]
    got = ms_deform_attn_pallas_packed(value, shapes, fx, fy, lanes, 6)
    assert max_err(got, ms_deform_attn_pallas_packed_plain(value, shapes, fx, fy, lanes)) <= tol
    got = ms_deform_attn_sepwin(value, shapes, loc, att, 6)
    assert max_err(got, ms_deform_attn_windowed(value, shapes, loc, att, 6)) <= tol
    assert [launches(ms_deform_attn_pallas_packed), launches(ms_deform_attn_sepwin)] == [
        b + 1 for b in before]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", [SHAPES, FULL_SHAPES])
def test_windowed_backward_kernels(cuda, dtype, shapes):
    (value, loc, att), g = window_case(shapes, 2, dtype, 5)
    lanes = pack(shapes, loc, att, 6)
    before = launches(ms_deform_attn_pallas_packed_bwd)
    got = grads_of(lambda *x: ms_deform_attn_pallas_packed(x[0], shapes, *x[1:], 6),
                   (value, *lanes), g)
    assert launches(ms_deform_attn_pallas_packed_bwd) == before + 1
    want = grads_of(lambda *x: ms_deform_attn_pallas_packed_plain(x[0], shapes, *x[1:]),
                    (value, *lanes), g)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= GRAD_TOL[dtype]
    before = launches(ms_deform_attn_sepwin_bwd)
    got = grads_of(lambda *x: ms_deform_attn_sepwin(x[0], shapes, x[1], x[2], 6),
                   (value, loc, att), g)
    assert launches(ms_deform_attn_sepwin_bwd) == before + 1
    want = grads_of(lambda *x: ms_deform_attn_windowed(x[0], shapes, x[1], x[2], 6),
                    (value, loc, att), g)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= GRAD_TOL[dtype]
    clamped = (got[1] == 0) & (want[1] == 0)
    assert clamped.any() and not clamped.all()  # some positions were clamped


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("q", [1, 50, 550])
def test_dense_fused_kernel(cuda, dtype, tol, q):
    rng = np.random.RandomState(q + 1)
    S = sum(h * w for h, w in FULL_SHAPES)
    value = torch.from_numpy(rng.randn(2, S, H, D).astype(np.float32)).to(cuda, dtype)
    loc = torch.from_numpy(rng.rand(2, q, H, L, P, 2).astype(np.float32) * 1.4 - 0.2).to(cuda)
    att = torch.softmax(torch.from_numpy(rng.randn(2, q, H, L * P).astype(np.float32)), -1)
    att = att.view(2, q, H, L, P).to(cuda)
    got = ms_deform_attn_dense_fused(value, FULL_SHAPES, loc, att)
    assert max_err(got, ms_deform_attn_dense(value, FULL_SHAPES, loc, att)) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q", [50, 550])
def test_dense_fused_backward_kernel(cuda, dtype, q):
    """Kernel 7's scatter-free backward against autograd through the plain
    version, and its value gradient bit-identical across two runs."""
    gen = torch.Generator(device="cuda").manual_seed(q + 1)
    S = sum(h * w for h, w in FULL_SHAPES)
    value = torch.randn(2, S, H, D, generator=gen, device="cuda").to(dtype)
    loc = sep_locations((2, q, H, L, P), FULL_SHAPES, gen)
    att = torch.softmax(torch.randn(2, q, H, L * P, generator=gen, device="cuda"), -1)
    att = att.view(2, q, H, L, P)
    g = torch.randn(2, q, H * D, generator=gen, device="cuda")
    before = launches(ms_deform_attn_dense_fused_bwd)
    got = grads_of(lambda *x: ms_deform_attn_dense_fused(x[0], FULL_SHAPES, x[1], x[2]),
                   (value, loc, att), g)
    assert launches(ms_deform_attn_dense_fused_bwd) == before + 1
    want = grads_of(lambda *x: ms_deform_attn_dense(x[0], FULL_SHAPES, x[1], x[2]),
                    (value, loc, att), g)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= GRAD_TOL[dtype]
    assert got[0].dtype == dtype
    gout = g.to(dtype)
    runs = [ms_deform_attn_dense_fused_bwd(value, FULL_SHAPES, loc, att, gout)[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def test_optin_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    (value, loc, att), _ = window_case(SHAPES, 1, torch.float32, 6)
    fx, fy, lanes = pack(SHAPES, loc, att, 6)
    with pytest.raises(TypeError):  # packed operands are f32
        ms_deform_attn_pallas_packed(value, SHAPES, fx.bfloat16(), fy, lanes, 6)
    with pytest.raises(ValueError):  # not contiguous
        ms_deform_attn_pallas_packed(value, SHAPES, fx, fy.transpose(1, 2).contiguous()
                                     .transpose(1, 2), lanes, 6)
    with pytest.raises(ValueError):  # on two devices
        ms_deform_attn_pallas_packed(value, SHAPES, fx.cpu(), fy, lanes, 6)
    with pytest.raises(ValueError):  # not grid queries
        ms_deform_attn_sepwin(value, SHAPES, loc[:, :-1], att[:, :-1], 6)
    with pytest.raises(TypeError):  # f32 locations
        ms_deform_attn_sepwin(value, SHAPES, loc.double(), att, 6)
    with pytest.raises(TypeError):
        ms_deform_attn_dense_fused(value, SHAPES, loc, att.bfloat16())
    with pytest.raises(TypeError):  # f32 or bf16 values
        ms_deform_attn_dense_fused(value.half(), SHAPES, loc, att)


def rel_err(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    return ((got.float() - want.float()).abs().max() / (1 + want.float().abs().max())).item()


def grads_of(fn, inputs, g):
    """Gradients of <g, fn(*inputs)> with respect to every input."""
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    (fn(*xs).float() * g).sum().backward()
    return [x.grad for x in xs]


def enc_inputs(shapes, B, dtype, seed, window=6):
    """Offsets are odd multiples of 1/32, some beyond the window (clamped
    to +-1.99 at G = 6): the grid centres are multiples of 1/16 at levels
    that halve, so every sample sits >= 0.01 px from an integer position,
    where the one-sided bilinear derivative would jump (ROADMAP.md C3)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    S = sum(h * w for h, w in shapes)
    lim = window_limit(window)
    value = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    off = (torch.rand(B, S, 256, generator=g, device="cuda") * 2 - 1) * (lim + 1)
    off = ((torch.floor(off * 16) * 2 + 1) / 32).to(dtype)
    logits = (torch.randn(B, S, 128, generator=g, device="cuda") * 2).to(dtype)
    gout = torch.randn(B, S, H * D, generator=g, device="cuda")
    return (value, off, logits), gout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", [SHAPES, FULL_SHAPES, STRESS_SHAPES, DILATED_SHAPES,
                                    ODD_SHAPES])
def test_enc_fused_backward_kernel(cuda, dtype, shapes):
    (value, off, logits), g = enc_inputs(shapes, 2, dtype, 3)
    before = launches(ms_deform_attn_enc_fused_bwd)
    got = grads_of(lambda *x: ms_deform_attn_enc_fused(x[0], shapes, x[1], x[2], 6),
                   (value, off, logits), g)
    assert launches(ms_deform_attn_enc_fused_bwd) == before + 1
    want = grads_of(lambda *x: ms_deform_attn_enc_fused_plain(x[0], shapes, x[1], x[2], 6),
                    (value, off, logits), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and rel_err(a, b) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes", [SHAPES, FULL_SHAPES, STRESS_SHAPES, DILATED_SHAPES,
                                    ODD_SHAPES])
def test_enc_fused_backward_kernel_at_g8(cuda, dtype, shapes):
    """The backward at G = 8: another tiling of every pyramid (at the full
    one a tile is half a pixel of the coarsest level across)."""
    (value, off, logits), g = enc_inputs(shapes, 2, dtype, 4, window=8)
    got = grads_of(lambda *x: ms_deform_attn_enc_fused(x[0], shapes, x[1], x[2], 8),
                   (value, off, logits), g)
    want = grads_of(lambda *x: ms_deform_attn_enc_fused_plain(x[0], shapes, x[1], x[2], 8),
                    (value, off, logits), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and rel_err(a, b) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [6, 8])
def test_enc_fused_backward_kernel_clustered_at_the_bound(cuda, dtype, window):
    """Every offset 1/32 to 1 px beyond the window, so every sample sits at
    one of the four corners of its query's window: the 4 points of a level
    share few positions and neighbouring queries' corners meet, so many
    samples add to the same staged rows.  Every offset was clamped, so
    doff is 0."""
    (value, off, logits), g = enc_inputs(FULL_SHAPES, 2, dtype, 5, window)
    lim = window_limit(window)
    off = (torch.sign(off.float()) * (lim + 1 / 32 + off.float().abs() % 1)).to(dtype)
    got = grads_of(lambda *x: ms_deform_attn_enc_fused(x[0], FULL_SHAPES, x[1], x[2], window),
                   (value, off, logits), g)
    want = grads_of(lambda *x: ms_deform_attn_enc_fused_plain(x[0], FULL_SHAPES, x[1], x[2],
                                                              window),
                    (value, off, logits), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and rel_err(a, b) <= GRAD_TOL[dtype]
    assert (got[1] == 0).all()


def test_enc_fused_refuses_what_the_backward_cannot_tile(cuda):
    """Kernel 1 refuses at forward time, with or without a gradient, a head
    count, a pyramid or a window that its backward's tiling cannot take;
    nothing is launched in its place."""
    before = (launches(ms_deform_attn_enc_fused), launches(ms_deform_attn_enc_fused_bwd))
    S = sum(h * w for h, w in FULL_SHAPES)
    for heads in (4, 16):  # 8 heads of 32 channels a token row
        value = torch.zeros(1, S, heads, D, device=cuda)
        off = torch.zeros(1, S, 2 * heads * L * P, device=cuda)
        logits = torch.zeros(1, S, heads * L * P, device=cuda)
        with pytest.raises(ValueError, match="8 heads"):
            ms_deform_attn_enc_fused(value, FULL_SHAPES, off, logits, 6)
    five = FULL_SHAPES + ((3, 10),)  # a fifth level: more than a block has warps for
    S5 = S + 30
    value = torch.zeros(1, S5, H, D, device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="at most 4 levels"):
        ms_deform_attn_enc_fused(value, five, torch.zeros(1, S5, 2 * H * 5 * P, device=cuda),
                                 torch.zeros(1, S5, H * 5 * P, device=cuda), 6)
    value = torch.zeros(1, S, H, D, device=cuda)
    with torch.no_grad(), pytest.raises(ValueError, match="shared memory"):
        ms_deform_attn_enc_fused(value, FULL_SHAPES, torch.zeros(1, S, 2 * H * L * P, device=cuda),
                                 torch.zeros(1, S, H * L * P, device=cuda), 64)
    assert before == (launches(ms_deform_attn_enc_fused), launches(ms_deform_attn_enc_fused_bwd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_enc_fused_backward_shares_an_sm(cuda, dtype):
    """Kernel 1's tile pass asks for the tiling's shared memory, as kernels
    5 and 6 do, and the runtime places two of its blocks on an SM."""
    blocks, smem = backward_occupancy(1, dtype, FULL_SHAPES, 6)
    assert smem == window_tiles(FULL_SHAPES, 6).smem_bytes and blocks == 2


def sep_locations(shape, shapes, gen):
    """Normalised locations whose pixel positions loc * (w, h) - 0.5 lie in
    [-1.5, size + 0.5] and >= 0.1 px from any integer."""
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device="cuda")
    u = torch.rand(*shape, 2, generator=gen, device="cuda")
    px = torch.floor(u * (wh[:, None] + 2) - 2) + 0.5 + (u * 997 % 1 - 0.5) * 0.8
    return (px + 0.5) / wh[:, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q", [50, 550])
def test_sep_backward_kernel(cuda, dtype, q):
    gen = torch.Generator(device="cuda").manual_seed(q)
    S = sum(h * w for h, w in FULL_SHAPES)
    value = torch.randn(2, S, H, D, generator=gen, device="cuda").to(dtype)
    loc = sep_locations((2, q, H, L, P), FULL_SHAPES, gen)
    att = torch.softmax(torch.randn(2, q, H, L * P, generator=gen, device="cuda"), -1)
    att = att.view(2, q, H, L, P)
    g = torch.randn(2, q, H * D, generator=gen, device="cuda")
    before = launches(ms_deform_attn_sep_bwd)
    got = grads_of(lambda *x: ms_deform_attn_sep(x[0], FULL_SHAPES, x[1], x[2]),
                   (value, loc, att), g)
    assert launches(ms_deform_attn_sep_bwd) == before + 1
    want = grads_of(lambda *x: ms_deform_attn(x[0], FULL_SHAPES, x[1], x[2]),
                    (value, loc, att), g)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk,p", [(1920, 1920, 0.0), (550, 1920, 0.1), (130, 70, 0.5),
                                     (7680, 7680, 0.1), (550, 7680, 0.1)])
def test_attention_forward_and_backward_with_the_kernels_mask(cuda, dtype, tq, tk, p):
    """With the keep mask the kernels draw, the kernel's output and
    gradients match autograd through the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(tq)
    q, k, v = (torch.randn(2, H, t, D, generator=gen, device=cuda).to(dtype)
               for t in (tq, tk, tk))
    g = torch.randn(2, H, tq, D, generator=gen, device=cuda)
    keep = attention_keep_mask((2, H, tq, tk), 11, p, cuda) if p > 0 else None
    assert max_err(fused_attention(q, k, v, 11, D ** -0.5, p),
                   attention_plain(q, k, v, D ** -0.5, keep, p)) <= 3 * TOL_OF[dtype]
    before = launches(fused_attention_bwd)
    got = grads_of(lambda *x: fused_attention(*x, 11, D ** -0.5, p), (q, k, v), g)
    assert launches(fused_attention_bwd) == before + 1
    want = grads_of(lambda *x: attention_plain(*x, D ** -0.5, keep, p), (q, k, v), g)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= GRAD_TOL[dtype]


TOL_OF = dict(DTYPES)


def test_attention_dropout_properties(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 2, t, D, generator=gen, device=cuda) for t in (256, 384, 384))
    a = fused_attention(q, k, v, 7, D ** -0.5, 0.1)
    assert torch.equal(a, fused_attention(q, k, v, 7, D ** -0.5, 0.1))
    assert not torch.equal(a, fused_attention(q, k, v, 8, D ** -0.5, 0.1))
    keep = attention_keep_mask((16, 8, 550, 1920), 5, 0.1, cuda)
    assert abs(keep.float().mean().item() - 0.9) < 0.005
    # E[dropout(out)] -> out: inverted scaling is unbiased
    mean = sum(fused_attention(q, k, v, s, D ** -0.5, 0.5) for s in range(40)) / 40
    d0 = fused_attention(q, k, v, 0, D ** -0.5, 0.0)
    assert (mean - d0).abs().mean() < 0.35 * d0.abs().mean()
    # out is linear in v: <g, out(v=d)> == <dL/dv, d> iff the backward
    # regenerates the forward's mask
    g = torch.randn(q.shape, generator=gen, device=cuda)
    d = torch.randn(v.shape, generator=gen, device=cuda)
    vv = v.clone().requires_grad_(True)
    (fused_attention(q, k, vv, 7, D ** -0.5, 0.1) * g).sum().backward()
    lhs = (fused_attention(q, k, d, 7, D ** -0.5, 0.1) * g).sum().item()
    rhs = (vv.grad * d).sum().item()
    assert abs(lhs - rhs) <= 1e-3 * abs(rhs)


def test_wrappers_pass_gradients_on_cuda(cuda):
    """Every differentiable input of the six kernel wrappers receives a
    finite, non-zero gradient on the card."""
    (value, off, logits), g = enc_inputs(SHAPES, 1, torch.float32, 1)
    for grad in grads_of(lambda *x: ms_deform_attn_enc_fused(x[0], SHAPES, x[1], x[2], 6),
                         (value, off, logits), g):
        assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    S = sum(h * w for h, w in SHAPES)
    loc = torch.rand(1, 7, H, L, P, 2, device=cuda)
    att = torch.softmax(torch.randn(1, 7, H, L * P, device=cuda), -1).view(1, 7, H, L, P)
    for grad in grads_of(lambda *x: ms_deform_attn_sep(x[0], SHAPES, x[1], x[2]),
                         (value[:, :S], loc, att), torch.randn(1, 7, H * D, device=cuda)):
        assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    for grad in grads_of(lambda *x: ms_deform_attn_dense_fused(x[0], SHAPES, x[1], x[2]),
                         (value[:, :S], loc, att), torch.randn(1, 7, H * D, device=cuda)):
        assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    (value, loc, att), g = window_case(SHAPES, 1, torch.float32, 2)
    for grad in grads_of(lambda *x: ms_deform_attn_sepwin(x[0], SHAPES, x[1], x[2], 6),
                         (value, loc, att), g):
        assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    for grad in grads_of(lambda *x: ms_deform_attn_pallas_packed(x[0], SHAPES, *x[1:], 6),
                         (value, *pack(SHAPES, loc, att, 6)), g):
        assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    q, k, v = (torch.randn(1, H, 40, D, device=cuda) for _ in range(3))
    for p in (0.0, 0.1):
        for grad in grads_of(lambda *x: fused_attention(*x, 3, D ** -0.5, p), (q, k, v),
                             torch.randn(1, H, 40, D, device=cuda)):
            assert torch.isfinite(grad).all() and grad.abs().sum() > 0


def lap_problems(n_problems, N, seed, device):
    """Costs from matching-like values with ties (rounded to 0.25), 0..N
    valid rows, BIG_COST rows for the padding."""
    rng = np.random.RandomState(seed)
    cost = np.round(rng.rand(n_problems, N, N) * 40) / 4
    n_valid = rng.randint(0, N + 1, n_problems)
    valid = np.arange(N)[None] < n_valid[:, None]
    cost = np.where(valid[..., None], cost, 1e6).astype(np.float32)
    return (torch.from_numpy(cost).to(device), torch.from_numpy(valid).to(device))


LAP_EDGE_CASES = {name: (cost, valid) for name, cost, valid in lap_edge_cases()}


@pytest.mark.parametrize("case", ["N=50", "N=7", "N=64"] + list(LAP_EDGE_CASES))
def test_lap_kernel_is_bit_identical(cuda, case):
    """528 problems at N = 50, 7 and 64, and ops/lap.py:lap_edge_cases
    (zeros of both signs, exact ties, scattered validity, no valid row, N
    of 1, 31, 32, 33 and 64 in odd counts of problems)."""
    if case in LAP_EDGE_CASES:
        cost, valid = (torch.from_numpy(x).to(cuda) for x in LAP_EDGE_CASES[case])
    else:
        N = int(case[2:])
        cost, valid = lap_problems(528, N, N, cuda)
    before = launches(lap_solve)
    got = lap_solve(cost, valid)
    assert launches(lap_solve) == before + 1
    want = lap_solve_plain(cost.cpu(), valid.cpu())
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq,tk", [(1920, 1920), (550, 1920), (50, 1920), (77, 130)])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_attention_kernels_against_plain(cuda, dtype, tq, tk, p):
    """The attention kernels (bf16: tensor cores; f32: scalar) at the main
    path's shapes and a ragged one, with the keep mask of
    attention_keep_mask given to the plain version: the output within TOL,
    the gradients of q, k and v within GRAD_TOL."""
    gen = torch.Generator(device=cuda).manual_seed(tq * 7 + tk)
    q, k, v = (torch.randn(2, H, t, D, generator=gen, device=cuda).to(dtype)
               for t in (tq, tk, tk))
    g = torch.randn(2, H, tq, D, generator=gen, device=cuda)
    keep = attention_keep_mask((2, H, tq, tk), 5, p, cuda) if p > 0 else None
    assert max_err(fused_attention(q, k, v, 5, D ** -0.5, p),
                   attention_plain(q, k, v, D ** -0.5, keep, p)) <= TOL_OF[dtype]
    got = grads_of(lambda *x: fused_attention(*x, 5, D ** -0.5, p), (q, k, v), g)
    want = grads_of(lambda *x: attention_plain(*x, D ** -0.5, keep, p), (q, k, v), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and rel_err(a, b) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_keep_bits_are_the_keep_mask(cuda, dtype):
    """The forward's and the dk/dv kernel's keep bits, read off exactly, are
    attention_keep_mask's.  With q = 0 every probability is 1 / Tk; with
    v[j] = 2^(j // 32) e_(j % 32), out[i, d] * Tk * (1 - p) is the integer
    whose bit m is keep[i, 32 m + d]; with dO built the same way over the
    queries, so is dv[j, d] * Tk * (1 - p) for keep[32 m + d, j]."""
    B, Tq, Tk, p = 2, 128, 130, 0.25

    def code(n):  # [n, 32]: row j = 2^(j // 32) e_(j % 32)
        x = torch.zeros(n, D, device=cuda)
        j = torch.arange(n, device=cuda)
        x[j, j % 32] = 2.0 ** (j // 32).float()
        return x

    def bits(x, n):  # [.., 32] integers -> [.., n] bits, column 32 m + d = bit m of x[d]
        x = torch.round(x.float()).long()
        m = torch.arange((n + 31) // 32, device=cuda)
        return ((x[..., None, :] >> m[:, None]) & 1).flatten(-2)[..., :n].bool()

    keep = attention_keep_mask((B, H, Tq, Tk), 9, p, cuda)
    q = torch.zeros(B, H, Tq, D, device=cuda, dtype=dtype)
    k = torch.randn(B, H, Tk, D, device=cuda).to(dtype)
    v = code(Tk).expand(B, H, Tk, D).contiguous().to(dtype)
    out = fused_attention(q, k, v, 9, D ** -0.5, p)
    assert torch.equal(bits(out * Tk * (1 - p), Tk), keep)
    go = code(Tq).expand(B, H, Tq, D).contiguous().to(dtype)
    _, _, dv = grads_of(lambda *x: fused_attention(*x, 9, D ** -0.5, p), (q, k, v), go)
    assert torch.equal(bits(dv * Tk * (1 - p), Tq), keep.transpose(-1, -2))


def enc_edge_case(case, dtype, seed=0):
    """(value, off, logits), gout at the small levels, where most queries sit
    on a level's border: 'clamp' offsets 0.5-3 px beyond the window (all
    clamped), 'border' offsets of up to the window pointing anywhere, with
    many samples outside the level (zero padding), 'spread' logits 200
    apart between heads, 'c3' offsets at odd multiples of 1/32 px (ROADMAP.md
    C3).  Every sample stays >= 0.01 px off integer positions."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    S = sum(h * w for h, w in SHAPES)
    lim = window_limit(6)
    u = torch.rand(1, S, 256, generator=g, device="cuda")
    sign = torch.where(torch.rand(1, S, 256, generator=g, device="cuda") < 0.5, -1.0, 1.0)
    if case == "clamp":
        off = sign * (lim + 0.5 + u * 2.5)
    elif case == "border":
        off = sign * u * lim
    else:
        off = (u * 2 - 1) * (lim + 1)
    off = (torch.floor(off * 16) * 2 + 1) / 32
    logits = torch.randn(1, S, H, L * P, generator=g, device="cuda") * 2
    if case == "spread":
        logits = logits + torch.linspace(-100, 100, H, device="cuda")[:, None]
    value = torch.randn(1, S, H, D, generator=g, device="cuda").to(dtype)
    gout = torch.randn(1, S, H * D, generator=g, device="cuda")
    return (value, off.to(dtype), logits.reshape(1, S, H * L * P).to(dtype)), gout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["clamp", "border", "spread", "c3"])
def test_enc_fused_kernels_on_edge_inputs(cuda, dtype, case):
    """Kernel 1 forward within TOL and backward within GRAD_TOL of its plain
    version (autograd through it) on the edge inputs of enc_edge_case."""
    (value, off, logits), g = enc_edge_case(case, dtype)
    got = ms_deform_attn_enc_fused(value, SHAPES, off, logits, 6)
    want = ms_deform_attn_enc_fused_plain(value, SHAPES, off, logits, 6)
    assert max_err(got, want) <= TOL_OF[dtype]
    got = grads_of(lambda *x: ms_deform_attn_enc_fused(x[0], SHAPES, x[1], x[2], 6),
                   (value, off, logits), g)
    want = grads_of(lambda *x: ms_deform_attn_enc_fused_plain(x[0], SHAPES, x[1], x[2], 6),
                    (value, off, logits), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and rel_err(a, b) <= GRAD_TOL[dtype]
    if case == "clamp":
        assert (got[1] == 0).all()  # every offset was clamped


def window_edge_case(case, shapes, B, dtype, seed=0, window=6):
    """((value, loc, attn), gout) for grid queries at the production
    levels, offsets at odd multiples of 1/32 px (every sample >= 1/32 px off
    integer positions, ROADMAP.md C3): 'inside' within the window, none
    clamped; 'border' as 'inside' for the queries within 2 px of a level's
    border only, pointing outwards, so their samples fall outside the level
    (zero padding), the other queries' weights 0; 'beyond' 0.5-3 px beyond
    the window on both axes; 'zero_att' as 'inside' with the weights of
    every third query and of head 5 set to 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    S = sum(h * w for h, w in shapes)
    lim = window_limit(window)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device="cuda")
    ref = torch.from_numpy(encoder_reference_points(shapes)).cuda()
    ref = ref[None, :, None, None, None, :]  # normalised centres [S, 2]
    u = torch.rand(B, S, H, L, P, 2, generator=g, device="cuda")
    sign = torch.where(torch.rand(u.shape, generator=g, device="cuda") < 0.5, -1.0, 1.0)
    att = torch.softmax(torch.randn(B, S, H, L * P, generator=g, device="cuda"), -1)
    att = att.view(B, S, H, L, P).clone()
    if case == "beyond":
        off = sign * (lim + 0.5 + u * 2.5)
    elif case == "border":
        centre = ref * wh[:, None] - 0.5  # [1, S, 1, L, 1, 2]
        near_lo, near_hi = centre < 2, centre > wh[:, None] - 3
        off = torch.where(near_hi, 1.0, -1.0) * u * (lim - 0.1)
        att = att * (near_lo | near_hi).any(-1).any(-1).any(-1)[..., None, None]
    else:
        off = sign * u * (lim - 0.1)
    if case == "zero_att":
        att[:, ::3] = 0
        att[:, :, 5] = 0
    loc = ref + (torch.floor(off * 16) * 2 + 1) / 32 / wh[:, None]
    value = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    gout = torch.randn(B, S, H * D, generator=g, device="cuda")
    return (value, loc, att), gout


def unclamped_lanes(shapes, loc, att):
    """Kernel 5's (fx, fy, att) at the pixel positions of `loc` as they are,
    not clamped to the window."""
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=loc.device)
    f = loc * wh[:, None] - 0.5
    return (to_lanes(f[..., 0]).contiguous(), to_lanes(f[..., 1]).contiguous(),
            to_lanes(att).contiguous())


def check_windowed_pair(shapes, value, loc, att, g, dtype, window=6):
    """Kernels 5 (at the positions as they are) and 6 (which clamps them),
    forward within TOL and every gradient within GRAD_TOL of the plain
    versions.  Returns kernel 6's gradients."""
    lanes = unclamped_lanes(shapes, loc, att)
    got = ms_deform_attn_pallas_packed(value, shapes, *lanes, window)
    want = ms_deform_attn_pallas_packed_plain(value, shapes, *lanes)
    assert max_err(got, want) <= TOL_OF[dtype]
    got = grads_of(lambda *x: ms_deform_attn_pallas_packed(x[0], shapes, *x[1:], window),
                   (value, *lanes), g)
    want = grads_of(lambda *x: ms_deform_attn_pallas_packed_plain(x[0], shapes, *x[1:]),
                    (value, *lanes), g)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= GRAD_TOL[dtype]
    got = ms_deform_attn_sepwin(value, shapes, loc, att, window)
    assert max_err(got, ms_deform_attn_windowed(value, shapes, loc, att, window)) <= TOL_OF[dtype]
    got = grads_of(lambda *x: ms_deform_attn_sepwin(x[0], shapes, x[1], x[2], window),
                   (value, loc, att), g)
    want = grads_of(lambda *x: ms_deform_attn_windowed(x[0], shapes, x[1], x[2], window),
                    (value, loc, att), g)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= GRAD_TOL[dtype]
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["inside", "border", "beyond", "zero_att"])
def test_windowed_kernels_on_edge_inputs(cuda, dtype, case):
    """Kernels 5 and 6 at the production levels on the inputs of
    window_edge_case.  'beyond': kernel 6 clamps every position and passes
    no location gradient; kernel 5 samples where it is told, outside the
    rectangles its backward stages, and stays exact."""
    (value, loc, att), g = window_edge_case(case, FULL_SHAPES, 2, dtype)
    grads = check_windowed_pair(FULL_SHAPES, value, loc, att, g, dtype)
    if case == "beyond":
        assert (grads[1] == 0).all()
    if case == "inside":
        assert (grads[1] != 0).float().mean() > 0.9  # nothing was clamped
    if case == "zero_att":
        assert grads[1][:, ::3].abs().max() == 0 and grads[2][:, ::3].abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_kernel_far_outside_the_level(cuda, dtype):
    """Kernel 5 at positions no int32 holds (+-3e9, +-1e12 px on every
    fifth query, x and y in turn): such a sample reads nothing and moves no
    gradient, as in the plain version, and the other queries stay exact."""
    (value, loc, att), g = window_edge_case("inside", FULL_SHAPES, 2, dtype)
    fx, fy, a = unclamped_lanes(FULL_SHAPES, loc, att)
    fx[:, 0::5] = 3e9
    fy[:, 1::5] = -3e9
    fx[:, 2::5] = -1e12
    fy[:, 3::5] = 1e12
    lanes = (fx, fy, a)
    got = ms_deform_attn_pallas_packed(value, FULL_SHAPES, *lanes, 6)
    want = ms_deform_attn_pallas_packed_plain(value, FULL_SHAPES, *lanes)
    assert torch.isfinite(got.float()).all() and max_err(got, want) <= TOL_OF[dtype]
    got = grads_of(lambda *x: ms_deform_attn_pallas_packed(x[0], FULL_SHAPES, *x[1:], 6),
                   (value, *lanes), g)
    want = grads_of(lambda *x: ms_deform_attn_pallas_packed_plain(x[0], FULL_SHAPES, *x[1:]),
                    (value, *lanes), g)
    for x, y in zip(got, want):
        assert torch.isfinite(x.float()).all() and rel_err(x, y) <= GRAD_TOL[dtype]
    assert got[1][:, 0::5].abs().max() == 0 and got[3][:, 2::5].abs().max() == 0


@pytest.mark.parametrize("B,window", [(1, 6), (3, 6), (3, 8), (2, 4)])
def test_windowed_kernels_at_other_batches_and_windows(cuda, B, window):
    """A batch of 1, an odd batch, and the tilings of other windows (G = 8:
    a tile half as wide as a pixel of the coarsest level)."""
    (value, loc, att), g = window_case(FULL_SHAPES, B, torch.float32, 7 + B, window)
    check_windowed_pair(FULL_SHAPES, value, loc, att, g, torch.float32, window)


@pytest.mark.parametrize("kernel", [5, 6])
def test_windowed_value_gradient_repeats(cuda, kernel):
    """Two runs of the backward give the same value gradient to 1e-6 of its
    maximum: within a block the sums have a fixed order, between blocks the
    rows are added by atomics."""
    (value, loc, att), g = window_case(FULL_SHAPES, 2, torch.float32, 11)
    if kernel == 5:
        lanes = pack(FULL_SHAPES, loc, att, 6)
        runs = [ms_deform_attn_pallas_packed_bwd(value, FULL_SHAPES, *lanes, g, 6)[0]
                for _ in range(2)]
    else:
        runs = [ms_deform_attn_sepwin_bwd(value, FULL_SHAPES, loc, att, g, 6)[0]
                for _ in range(2)]
    torch.cuda.synchronize()
    assert (runs[0] - runs[1]).abs().max() <= 1e-6 * runs[0].abs().max()


def test_windowed_wrappers_refuse_a_window_that_does_not_fit(cuda):
    """A window whose smallest tile does not fit shared memory raises in
    the wrapper, forward and backward; nothing else is run in its place."""
    (value, loc, att), g = window_case(FULL_SHAPES, 1, torch.float32, 3)
    lanes = pack(FULL_SHAPES, loc, att, 6)
    before = [launches(f) for f in (ms_deform_attn_sepwin, ms_deform_attn_pallas_packed,
                                   ms_deform_attn_sepwin_bwd, ms_deform_attn_pallas_packed_bwd)]
    with pytest.raises(ValueError, match="shared memory"):
        ms_deform_attn_sepwin(value, FULL_SHAPES, loc, att, 64)
    with pytest.raises(ValueError, match="shared memory"):
        ms_deform_attn_pallas_packed(value, FULL_SHAPES, *lanes, 64)
    with pytest.raises(ValueError, match="shared memory"):
        ms_deform_attn_sepwin_bwd(value, FULL_SHAPES, loc, att, g, 64)
    with pytest.raises(ValueError, match="shared memory"):
        ms_deform_attn_pallas_packed_bwd(value, FULL_SHAPES, *lanes, g, 64)
    assert before == [launches(f) for f in (
        ms_deform_attn_sepwin, ms_deform_attn_pallas_packed, ms_deform_attn_sepwin_bwd,
        ms_deform_attn_pallas_packed_bwd)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_backward_shares_an_sm(cuda, dtype):
    """The shared memory the backward asks for is the tiling's, and the
    runtime places two of its blocks on an SM."""
    for kernel in (5, 6):
        blocks, smem = backward_occupancy(kernel, dtype, FULL_SHAPES, 6)
        assert smem == window_tiles(FULL_SHAPES, 6).smem_bytes and blocks == 2


LOC_KERNELS = {
    "sep": (ms_deform_attn_sep, ms_deform_attn_sep_bwd),
    "dense_fused": (ms_deform_attn_dense_fused, ms_deform_attn_dense_fused_bwd),
}


def loc_edge_case(case, dtype, seed=0):
    """((value, loc, attn), gout) for decoder queries at the production
    levels, every sample >= 0.1 px off integer positions (ROADMAP.md C3):
    'lp32' 8 points a level (32 samples per head); 'b1' and 'b3' batches of
    1 and 3; 'border' every sample within 1.5 px of a level's border, half
    of them outside; 'far' as 'b3' with +-3e9 and +-1e12 px on every fifth
    query (x and y in turn); 'zero_att' the weights of every third query
    and of head 5 zero; 'one_pixel' all 550 queries' samples in one pixel
    of each level."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = {"b1": 1, "b3": 3, "far": 3}.get(case, 2)
    q = 550 if case == "one_pixel" else 77
    p = 8 if case == "lp32" else P
    S = sum(h * w for h, w in FULL_SHAPES)
    wh = torch.tensor([[w, h] for h, w in FULL_SHAPES], dtype=torch.float32, device="cuda")
    u = torch.rand(B, q, H, L, p, 2, generator=g, device="cuda")
    jitter = (u * 997 % 1 - 0.5) * 0.8
    if case == "border":
        side = torch.rand(u.shape, generator=g, device="cuda") < 0.5
        near = torch.floor(u * 3) - 2  # pixel -2, -1 or 0 from the border
        px = torch.where(side, near, wh[:, None] - 1 - near) + 0.5 + jitter
    elif case == "one_pixel":
        px = torch.floor(wh[:, None] * 0.4) + 0.5 + jitter
    else:
        px = torch.floor(u * (wh[:, None] + 2) - 2) + 0.5 + jitter
    if case == "far":
        px[:, 0::5, ..., 0] = 3e9
        px[:, 1::5, ..., 1] = -3e9
        px[:, 2::5, ..., 0] = -1e12
        px[:, 3::5, ..., 1] = 1e12
    loc = (px + 0.5) / wh[:, None]
    att = torch.softmax(torch.randn(B, q, H, L * p, generator=g, device="cuda"), -1)
    att = att.view(B, q, H, L, p).clone()
    if case == "zero_att":
        att[:, ::3] = 0
        att[:, :, 5] = 0
    value = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    gout = torch.randn(B, q, H * D, generator=g, device="cuda")
    return (value, loc, att), gout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["sep", "dense_fused"])
@pytest.mark.parametrize("case", ["lp32", "b1", "b3", "border", "far", "zero_att", "one_pixel"])
def test_loc_kernels_on_edge_inputs(cuda, dtype, kernel, case):
    """Kernels 2 and 7 forward within TOL and backward within GRAD_TOL of
    the plain version on the inputs of loc_edge_case; kernel 7's value
    gradient the same bits in a second run on every one of them."""
    fwd, bwd = LOC_KERNELS[kernel]
    (value, loc, att), g = loc_edge_case(case, dtype)
    got = fwd(value, FULL_SHAPES, loc, att)
    assert max_err(got, ms_deform_attn(value, FULL_SHAPES, loc, att)) <= TOL_OF[dtype]
    got = grads_of(lambda *x: fwd(x[0], FULL_SHAPES, x[1], x[2]), (value, loc, att), g)
    want = grads_of(lambda *x: ms_deform_attn(x[0], FULL_SHAPES, x[1], x[2]), (value, loc, att), g)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= GRAD_TOL[dtype]
    if case == "far":  # such a sample reads nothing and moves no gradient
        assert got[1][:, 0::5, ..., 0].abs().max() == 0
        assert got[1][:, 2::5, ..., 0].abs().max() == 0
    if case == "zero_att":
        assert got[1][:, ::3].abs().max() == 0 and got[2][:, ::3].abs().max() > 0
    if kernel == "dense_fused":
        runs = [bwd(value, FULL_SHAPES, loc, att, g.to(dtype))[0] for _ in range(2)]
        assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["sep", "dense_fused"])
def test_loc_kernels_on_a_level_of_many_tiles(cuda, dtype, kernel):
    """A level of 300 x 260 pixels is 33 x 38 = 1,254 tiles of kernel 7's
    value side, more than its binning kernel sorts at a time (1,024): it
    takes them in two slabs.  Samples uniform over the level and 2 px
    around it, so both slabs and the tiles on either side of their border
    (tile row 31: pixel rows 248-255) hold entries.  Forward and backward of
    both kernels against the plain version; kernel 7's value gradient the
    same bits in a second run, and not 0 in the second slab."""
    shapes = ((300, 260), (16, 9))
    fwd, bwd = LOC_KERNELS[kernel]
    g = torch.Generator(device="cuda").manual_seed(13)
    B, q, S = 2, 300, sum(h * w for h, w in shapes)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device="cuda")
    u = torch.rand(B, q, H, 2, P, 2, generator=g, device="cuda")
    px = torch.floor(u * (wh[:, None] + 2) - 2) + 0.5 + (u * 997 % 1 - 0.5) * 0.8
    loc = (px + 0.5) / wh[:, None]
    att = torch.softmax(torch.randn(B, q, H, 2 * P, generator=g, device="cuda"), -1)
    att = att.view(B, q, H, 2, P)
    value = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    gout = torch.randn(B, q, H * D, generator=g, device="cuda")
    got = fwd(value, shapes, loc, att)
    assert max_err(got, ms_deform_attn(value, shapes, loc, att)) <= TOL_OF[dtype]
    got = grads_of(lambda *x: fwd(x[0], shapes, x[1], x[2]), (value, loc, att), gout)
    want = grads_of(lambda *x: ms_deform_attn(x[0], shapes, x[1], x[2]), (value, loc, att), gout)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= GRAD_TOL[dtype]
    assert got[0][:, 256 * 260:300 * 260].abs().max() > 0
    if kernel == "dense_fused":
        runs = [bwd(value, shapes, loc, att, gout.to(dtype))[0] for _ in range(2)]
        assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("kernel", ["sep", "dense_fused"])
def test_loc_wrappers_refuse_tokens_past_32_bit_offsets(cuda, kernel):
    """One level of 2048 x 2048 tokens of 8 heads: a batch item's S * H * 64
    passes INT32_MAX, which the kernels' 32-bit offsets do not reach.  Both
    directions raise and launch nothing."""
    rows = width = 2048
    shapes, S = ((rows, width),), rows * width
    assert not fits_int32(S, H) and fits_int32(S - 1, H)
    fwd, bwd = LOC_KERNELS[kernel]
    value = torch.empty(1, S, H, D, device=cuda, dtype=torch.bfloat16)
    loc = torch.rand(1, 4, H, 1, P, 2, device=cuda)
    att = torch.full((1, 4, H, 1, P), 1 / P, device=cuda)
    before = (launches(fwd), launches(bwd))
    with pytest.raises(ValueError, match="32-bit offsets"):
        fwd(value, shapes, loc, att)
    with pytest.raises(ValueError, match="32-bit offsets"):
        bwd(value, shapes, loc, att, torch.zeros(1, 4, H * D, device=cuda, dtype=torch.bfloat16))
    assert before == (launches(fwd), launches(bwd))


def test_loc_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    S = sum(h * w for h, w in SHAPES)
    value = torch.zeros(1, S, H, D, device=cuda)
    loc = torch.rand(1, 5, H, L, 9, 2, device=cuda)  # 36 samples per head
    att = torch.full((1, 5, H, L, 9), 1 / 36, device=cuda)
    before = [launches(f) for pair in LOC_KERNELS.values() for f in pair]
    for fwd, bwd in LOC_KERNELS.values():
        with pytest.raises(ValueError, match="samples per head"):
            fwd(value, SHAPES, loc, att)
        with pytest.raises(ValueError, match="samples per head"):
            bwd(value, SHAPES, loc, att, torch.zeros(1, 5, H * D, device=cuda))
        with pytest.raises(ValueError, match="32 channels"):
            fwd(torch.zeros(1, S, H, 16, device=cuda), SHAPES, loc[..., :4, :].contiguous(),
                att[..., :4].contiguous())
    assert before == [launches(f) for pair in LOC_KERNELS.values() for f in pair]


def test_remat_step_on_the_card_equals_the_step_without(cuda):
    """One f32 train step (2 + 2 layers, 128x256, B=2, dropout 0.1 from
    one CUDA generator) with remat True and without: the losses and the
    generator's final state equal, every gradient within 1e-5 of its
    largest entry (kernels 1 and 2 sum the value gradient by atomics, in
    another order from run to run; the same bound holds two runs without
    remat to each other)."""
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.train.synthetic import make_targets
    from monodetr_torch.train.train_step import TARGET_KEYS

    cfg = dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep", enc_layers=2,
               dec_layers=2, dropout=0.1)
    models = {remat: build_monodetr(dict(cfg, remat=remat), seed=0).to(cuda)
              for remat in (False, True)}
    crit = SetCriterion(cfg)
    rng = np.random.RandomState(5)
    images = torch.from_numpy(rng.randn(2, 128, 256, 3).astype(np.float32)).to(cuda)
    calibs = torch.tensor([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                          device=cuda).expand(2, 3, 4)
    sizes = torch.tensor([[1242.0, 375.0]], device=cuda).expand(2, 2)
    targets = {k: torch.from_numpy(v).to(cuda) for k, v in make_targets(rng, 2).items()
               if k in TARGET_KEYS}
    runs = []
    for remat in (False, True, False):
        model = models[remat]
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device=cuda).manual_seed(3)
        out = model(images, calibs, sizes, train=True, gen=gen)
        losses = crit(out, targets)
        crit.total(losses).backward()
        runs.append((torch.stack([losses[k].detach() for k in sorted(losses)]),
                     {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None}, gen.get_state()))
    for other in runs[1:]:
        assert torch.equal(other[0], runs[0][0]) and torch.equal(other[2], runs[0][2])
        assert other[1].keys() == runs[0][1].keys()
        for n, g in runs[0][1].items():
            assert (other[1][n] - g).abs().max() <= 1e-5 * g.abs().max() + 1e-12, n


def test_prefetched_step_makes_no_synchronizing_call(cuda):
    """The handoff (data/device_prefetch.py) and bf16 train steps (2 + 2
    layers, 128x256, B=2, dropout 0.1) under
    torch.cuda.set_sync_debug_mode("error"): no call waits for the card;
    the blocking pageable copy, under the same mode, raises."""
    from monodetr_torch.data.device_prefetch import DevicePrefetcher
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.train.optimizer import build_optimizer
    from monodetr_torch.train.synthetic import SyntheticLoader
    from monodetr_torch.train.train_step import batch_to_device, make_train_step

    cfg = dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep", enc_layers=2,
               dec_layers=2, dropout=0.1)
    model = build_monodetr(cfg, seed=0).to(cuda)
    step = make_train_step(model, SetCriterion(cfg),
                           build_optimizer({"type": "adamw", "lr": 2e-4}, model), torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = next(iter(SyntheticLoader(1, 2, 0, 128, 256)))[0]
    step(batch_to_device(batch, cuda), 2e-4, gen)  # first-call set-up, outside the check
    torch.cuda.synchronize()
    losses = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for on_card, _, _ in DevicePrefetcher(SyntheticLoader(4, 2, 1, 128, 256), cuda):
            losses.append(step(on_card, 2e-4, gen))
        with pytest.raises(RuntimeError, match="synchroniz"):
            torch.from_numpy(batch["images"]).to(cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    values = torch.stack([lv.values for lv in losses])
    assert len(losses) == 4 and torch.isfinite(values).all()


def test_pinned_copies_are_bit_equal_to_the_blocking_copy(cuda):
    """batch_to_device on the card (pinned host copies, non-blocking) and
    the prefetcher's side-stream copies give the blocking pageable copy's
    tensors bit for bit, mask as bool; the pinned buffers may be freed
    while the copies are in flight."""
    from monodetr_torch.data.device_prefetch import DevicePrefetcher
    from monodetr_torch.train.synthetic import SyntheticLoader
    from monodetr_torch.train.train_step import BATCH_KEYS, batch_to_device

    def blocking(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(
            cuda, torch.bool if k == "mask" else None) for k in BATCH_KEYS}

    loader = SyntheticLoader(5, 4, 2, 384, 1280)
    prefetched = list(DevicePrefetcher(loader, cuda))
    direct = [(batch_to_device(b, cuda), b) for b, _ in loader]
    torch.cuda.synchronize()
    assert len(prefetched) == len(direct) == 5
    for (on_card, batch, _), (copied, batch2) in zip(prefetched, direct):
        want = blocking(batch)
        for k in BATCH_KEYS:
            assert on_card[k].device.type == "cuda" and on_card[k].dtype == want[k].dtype, k
            assert torch.equal(on_card[k], want[k]), k
            assert torch.equal(copied[k], blocking(batch2)[k]), k


def _graph_call(step, inputs):
    """step(*inputs), and what its `eval step` root says the call did."""
    out = step(*inputs)
    counts = trace.last("eval step", 1)[0].counts
    kind = ("replay" if counts.get("eval_graph_replay") else
            "capture" if counts.get("eval_graph_capture") else "eager")
    return out, kind


def _frames(cuda, batch, n, seed=3):
    from monodetr_torch.train.synthetic import SyntheticLoader

    keys = ("images", "calibs", "img_sizes")
    return [tuple(torch.from_numpy(b[k]).to(cuda) for k in keys)
            for b, _ in SyntheticLoader(n, batch, seed, 128, 256)]


def _small_model(cuda, seed=0):
    from monodetr_torch.config import MONODETR_MODEL

    cfg = dict(MONODETR_MODEL, enc_layers=1, dec_layers=1)
    return cfg, build_monodetr(cfg, seed=seed).to(cuda)


def _eager(model, inputs, autocast):
    """The eval step's answer without a graph: a fresh step's first call."""
    from monodetr_torch.train.train_step import make_eval_step

    with autocast():
        out, kind = _graph_call(make_eval_step(model), inputs)
    assert kind == "eager"
    return out


@pytest.mark.parametrize("amp", [None, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 2])
def test_eval_step_replays_its_cuda_graph(cuda, amp, batch):
    """make_eval_step on the card, 1+1 layers at 128x256: calls 1, 2 and 3
    of a key run eagerly, capture and replay (the counters of their `eval
    step` roots); the replayed detections equal the eager step's bit for
    bit, in f32 and under bf16 autocast (the same kernels on the same
    inputs; the bf16 casts of the weights are the graph's nodes instead of
    autocast's cache, the same casts); an output held from one call is
    unchanged by the next; weights loaded in place, the caller's autocast
    left and entered again, and the constant tables' cache cleared (and
    its freed memory overwritten) between replays all give the eager
    answer."""
    from monodetr_torch.ops.utils import device_constant
    from monodetr_torch.train.train_step import make_eval_step

    cfg, model = _small_model(cuda)
    frames = _frames(cuda, batch, 4)

    def autocast():
        return torch.autocast("cuda", dtype=torch.bfloat16, enabled=amp is not None)

    step = make_eval_step(model)
    with autocast():
        calls = [_graph_call(step, f) for f in frames]
        assert [k for _, k in calls] == ["eager", "capture", "replay", "replay"]
        held = calls[3][0]
        kept = held.clone()
        again, kind = _graph_call(step, frames[0])
        assert kind == "replay" and torch.equal(held, kept) and not torch.equal(again, kept)
    assert held.shape == (batch, 50, 37) and torch.isfinite(held).all()
    for f, (out, _) in zip(frames, calls):
        assert torch.equal(out, _eager(model, f, autocast))
    assert torch.equal(again, calls[0][0])

    model.load_state_dict(build_monodetr(cfg, seed=1).state_dict())
    with autocast():  # left after the replays above, entered again
        got, kind = _graph_call(step, frames[1])
    assert kind == "replay" and not torch.equal(got, calls[1][0])
    assert torch.equal(got, _eager(model, frames[1], autocast))

    device_constant.cache_clear()
    junk = [torch.full((n,), float("nan"), device=cuda) for n in (2 ** k for k in range(6, 21))
            for _ in range(4)]
    with autocast():
        got, kind = _graph_call(step, frames[2])
    assert kind == "replay" and torch.isfinite(got).all()
    assert torch.equal(got, _eager(model, frames[2], autocast))
    del junk


def test_eval_step_recaptures_when_a_parameter_moves_or_is_replaced(cuda):
    """A parameter moved (new storage) or replaced (a new Parameter in its
    module) is never replayed from the old graph: the next call runs
    eagerly, the one after captures anew, and each gives the eager
    answer of the weights as they are."""
    from monodetr_torch.train.train_step import make_eval_step

    _, model = _small_model(cuda)
    frames = _frames(cuda, 1, 3)
    step = make_eval_step(model)
    assert [_graph_call(step, f)[1] for f in frames] == ["eager", "capture", "replay"]
    for p in model.parameters():
        p.data = p.data.clone()
    kinds = []
    for f in frames:
        out, kind = _graph_call(step, f)
        kinds.append(kind)
        assert torch.equal(out, _eager(model, f, contextlib.nullcontext))
    assert kinds == ["eager", "capture", "replay"]
    head = model.class_embed[0]
    head.bias = torch.nn.Parameter(head.bias.detach() + 1.0)
    out, kind = _graph_call(step, frames[0])
    assert kind == "eager" and torch.equal(out, _eager(model, frames[0], contextlib.nullcontext))
    assert [_graph_call(step, f)[1] for f in frames[1:]] == ["capture", "replay"]


def test_eval_step_captures_beside_the_prefetcher(cuda):
    """The tester's loop: batches staged by DevicePrefetcher's thread
    (pinned copies on its own stream) while the eval step captures and
    replays on the main thread; every batch's detections equal the eager
    step's, under bf16 autocast."""
    from monodetr_torch.data.device_prefetch import DevicePrefetcher
    from monodetr_torch.train.synthetic import SyntheticLoader
    from monodetr_torch.train.train_step import make_eval_step

    _, model = _small_model(cuda)
    keys = ("images", "calibs", "img_sizes")

    def autocast():
        return torch.autocast("cuda", dtype=torch.bfloat16)

    step = make_eval_step(model)
    got, kinds, inputs = [], [], []
    with autocast():
        for on_card, _, _ in DevicePrefetcher(SyntheticLoader(5, 2, 4, 128, 256), cuda, keys):
            out, kind = _graph_call(step, [on_card[k] for k in keys])
            got.append(out)
            kinds.append(kind)
            inputs.append([on_card[k].clone() for k in keys])
    assert kinds == ["eager", "capture", "replay", "replay", "replay"]
    for out, x in zip(got, inputs):
        assert torch.equal(out, _eager(model, x, autocast))


def test_eval_step_graphs_of_two_shapes_share_a_pool(cuda):
    """Two input shapes in turn (the tester's full batches and its ragged
    last one): each key runs eagerly, captures and replays on its own,
    both graphs in one memory pool, and every call equals the eager
    step."""
    from monodetr_torch.train.train_step import make_eval_step

    _, model = _small_model(cuda)
    one, two = _frames(cuda, 1, 4, seed=5), _frames(cuda, 2, 4, seed=6)
    step = make_eval_step(model)
    kinds = []
    with torch.autocast("cuda", dtype=torch.bfloat16):
        for a, b in zip(one, two):
            for f in (a, b):
                out, kind = _graph_call(step, f)
                kinds.append(kind)
                assert torch.equal(out, _eager(model, f, contextlib.nullcontext))
    assert kinds == ["eager"] * 2 + ["capture"] * 2 + ["replay"] * 4
