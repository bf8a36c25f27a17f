"""monodetr_torch model modules against their flax counterparts, and the
whole eval forward against MonoDETR.apply(train=False), in f32 on the CPU.

Weights: the port's seeded init, with random frozen-BN statistics and
random sampling-offset and attention-weight kernels (so that samples move
and some are clamped), goes through tools/convert_checkpoint.py:
convert_state_dict to a JAX tree; the port then loads that tree through
params_from_jax.  Both packages thus run the same weights on the same
numpy inputs.  128x256 input: the four levels (16,32), (8,16), (4,8),
(2,4) halve exactly, as ms_deform_attn_windowed needs.  The JAX side runs
msda_impl 'windowed' (the function of 'fused', 'pallas' and 'sepwin', with
no interpret mode) and dec_msda_impl 'sep' or 'dense' (their XLA path on
the CPU, the function of 'dense_fused').  Every MSDeformAttn impl is held
against the JAX module at module level, and the state_dict made by
params_from_jax loads into the model under every impl.

Tolerances: rtol 1e-4, atol 1e-5 for a module; 1e-3 (rtol and atol) for the
whole forward, through ResNet-50 and the inverse-sigmoid box refinement.
"""

import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, "tools")
from convert_checkpoint import convert_state_dict  # noqa: E402

from monodetr_tpu.models import build_monodetr as jax_build  # noqa: E402
from monodetr_tpu.models.backbone import ResNetBackbone as JaxBackbone  # noqa: E402
from monodetr_tpu.models.depth_predictor import DepthPredictor as JaxDepthPredictor  # noqa: E402
from monodetr_tpu.models.layers import MLP as JaxMLP  # noqa: E402
from monodetr_tpu.models.msda_module import MSDeformAttn as JaxMSDA  # noqa: E402
from monodetr_tpu.models.transformer import (  # noqa: E402
    DepthAwareDecoderLayer as JaxDecoderLayer, VisualEncoderLayer as JaxEncoderLayer)
from monodetr_torch.convert import params_from_jax  # noqa: E402
from monodetr_torch.models.monodetr import build_monodetr  # noqa: E402
from monodetr_torch.models.msda_module import MSDeformAttn  # noqa: E402
from monodetr_torch.models.transformer import encoder_reference_points  # noqa: E402

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5
IMG_H, IMG_W, B = 128, 256, 2
SHAPES = ((16, 32), (8, 16), (4, 8), (2, 4))
S = sum(h * w for h, w in SHAPES)
CFG = dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep", dtype="float32",
           enc_layers=2, dec_layers=2)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def weights():
    """(JAX params tree, port model loaded through params_from_jax)."""
    rng = np.random.RandomState(0)
    sd = {k: v.numpy().copy() for k, v in build_monodetr(CFG, seed=0).state_dict().items()}
    for k, v in sd.items():
        if k.endswith("running_var") or (".bn" in k and k.endswith("weight")):
            sd[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        elif k.endswith("running_mean") or (".bn" in k and k.endswith("bias")):
            sd[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("sampling_offsets.weight"):
            sd[k] = (rng.randn(*v.shape) * 0.03).astype(np.float32)
        elif k.endswith("attention_weights.weight"):
            sd[k] = (rng.randn(*v.shape) * 0.05).astype(np.float32)
    tree = convert_state_dict(sd, enc_layers=2, dec_layers=2)
    model = build_monodetr(CFG)
    model.load_state_dict(params_from_jax(tree))
    return tree["params"], model


def inputs(seed=1):
    rng = np.random.RandomState(seed)
    images = rng.randn(B, IMG_H, IMG_W, 3).astype(np.float32)
    calibs = np.tile(np.array([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                              np.float32), (B, 1, 1))
    calibs[1, 0, 0] = 650.0
    sizes = np.tile(np.array([[1242.0, 375.0]], np.float32), (B, 1))
    return images, calibs, sizes


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def nchw(x):
    return t(x).permute(0, 3, 1, 2)


def test_backbone(weights):
    params, model = weights
    images = inputs()[0]
    want = jax.jit(lambda p, x: JaxBackbone().apply({"params": p}, x))(
        params["backbone"], images)
    with torch.no_grad():
        got = model.backbone[0](nchw(images))
    for g, w in zip(got, want):
        close(g.permute(0, 2, 3, 1), w, rtol=1e-4, atol=1e-4)  # 50 convs deep


def test_input_proj_conv_gn(weights):
    from monodetr_tpu.models.layers import ConvGN

    params, model = weights
    x = np.random.RandomState(2).randn(B, 4, 8, 2048).astype(np.float32)
    want = ConvGN(256, kernel=3, stride=2).apply({"params": params["input_proj_3"]}, x)
    with torch.no_grad():
        got = model.input_proj[3](nchw(x))
    close(got.permute(0, 2, 3, 1), want)


def test_depth_predictor(weights):
    params, model = weights
    rng = np.random.RandomState(3)
    srcs = [rng.randn(B, h, w, 256).astype(np.float32) for h, w in SHAPES]
    pos = rng.randn(B, 8, 16, 256).astype(np.float32)
    want = jax.jit(lambda p: JaxDepthPredictor().apply({"params": p}, srcs, pos))(
        params["depth_predictor"])
    with torch.no_grad():
        got = model.depth_predictor([nchw(s) for s in srcs], t(pos).reshape(B, -1, 256))
    for g, w in zip(got, want):  # three 3x3 conv-GN blocks (2304-term sums) deep
        close(g, w, rtol=1e-4, atol=1e-4)


def test_encoder_layer(weights):
    params, model = weights
    rng = np.random.RandomState(4)
    src = rng.randn(B, S, 256).astype(np.float32)
    pos = rng.randn(B, S, 256).astype(np.float32)
    ref = np.broadcast_to(encoder_reference_points(SHAPES)[None, :, None], (B, S, 4, 2))
    layer = JaxEncoderLayer(msda_impl="windowed", msda_window=6)
    want = jax.jit(lambda p: layer.apply({"params": p}, src, pos, ref, SHAPES))(
        params["transformer"]["encoder_layer_0"])
    with torch.no_grad():
        got = model.depthaware_transformer.encoder.layers[0](t(src), t(pos), t(ref), SHAPES)
    close(got, want)


@pytest.mark.parametrize("ref_dim", [2, 6])
def test_decoder_layer(weights, ref_dim):
    params, model = weights
    rng = np.random.RandomState(5 + ref_dim)
    Q = 50
    tgt, query_pos = (rng.randn(B, Q, 256).astype(np.float32) for _ in range(2))
    src = rng.randn(B, S, 256).astype(np.float32)
    depth = rng.randn(B, 8 * 16, 256).astype(np.float32)
    ref = rng.rand(B, Q, ref_dim).astype(np.float32) * 0.8 + 0.1
    if ref_dim == 6:
        ref[..., 2:] *= 0.3  # box extents
    ref = np.broadcast_to(ref[:, :, None], (B, Q, 4, ref_dim))
    layer = JaxDecoderLayer(msda_impl="sep")
    want = jax.jit(lambda p: layer.apply({"params": p}, tgt, query_pos, ref, src, SHAPES,
                                         depth, train=False))(
        params["transformer"]["decoder_layer_1"])
    with torch.no_grad():
        got = model.depthaware_transformer.decoder.layers[1](
            t(tgt), t(query_pos), t(ref), t(src), SHAPES, t(depth))
    close(got, want)


@pytest.mark.parametrize("ref_dim", [2, 6])
def test_msda_gather_impl(weights, ref_dim):
    """The exact plain path against the JAX 'gather' impl, arbitrary queries."""
    params, model = weights
    rng = np.random.RandomState(7 + ref_dim)
    Q = 30
    query = rng.randn(B, Q, 256).astype(np.float32)
    value = rng.randn(B, S, 256).astype(np.float32)
    ref = rng.rand(B, Q, 4, ref_dim).astype(np.float32) * 0.8 + 0.1
    p = params["transformer"]["decoder_layer_0"]["cross_attn"]
    want = JaxMSDA(impl="gather").apply({"params": p}, query, ref, value, SHAPES)
    m = MSDeformAttn(impl="gather")
    prefix = "depthaware_transformer.decoder.layers.0.cross_attn."
    m.load_state_dict({k[len(prefix):]: v for k, v in model.state_dict().items()
                       if k.startswith(prefix)})
    with torch.no_grad():
        got = m(t(query), t(ref), t(value), SHAPES)
    close(got, want)


def exact_offsets(rng, p, reach):
    """The sampling_offsets params of p with a kernel of entries in
    {-1/16, 0, 1/16} (mostly 0) and a bias of odd multiples of 1/32 within
    +-reach: for a query in {-1, 0, 1} every offset is an odd multiple of
    1/32 px, computed exactly by both packages.  At grid centres (multiples
    of 1/16 px) or at reference points that are multiples of 1/32, no
    sample then sits on an integer position, where the one-sided bilinear
    derivative and the hat's -sign(0) = 0 differ, or within 0.02 px of the
    window's bound (ROADMAP.md C3)."""
    k = np.asarray(p["sampling_offsets"]["kernel"])
    kernel = rng.choice([-1 / 16, 0.0, 1 / 16], p=[0.05, 0.9, 0.05], size=k.shape)
    bias = (np.floor((rng.rand(k.shape[1]) * 2 - 1) * reach * 16) * 2 + 1) / 32
    return dict(p, sampling_offsets={"kernel": kernel.astype(np.float32),
                                     "bias": bias.astype(np.float32)})


@pytest.fixture(scope="module")
def msda_references(weights):
    """The JAX side of test_msda_optin_impl, computed once per JAX impl:
    {impl: (params, ref, query, value, g, output, (dparams, dquery, dvalue))}."""
    params, _ = weights
    refs = {}
    for jax_impl in ("windowed", "dense"):
        rng = np.random.RandomState(len(jax_impl))
        if jax_impl == "windowed":  # the encoder's grid queries
            Q, layer = S, params["transformer"]["encoder_layer_0"]["self_attn"]
            ref = np.broadcast_to(encoder_reference_points(SHAPES)[None, :, None], (B, S, 4, 2))
            p = exact_offsets(rng, layer, 1.99 + 1)  # inside and beyond the G = 6 window
        else:  # decoder queries, some samples beyond [0, 1]
            Q, layer = 30, params["transformer"]["decoder_layer_0"]["cross_attn"]
            ref = rng.randint(-8, 40, (B, Q, 4, 2)) / 32
            p = exact_offsets(rng, layer, 3)
        ref = np.ascontiguousarray(ref, np.float32)
        query = rng.randint(-1, 2, (B, Q, 256)).astype(np.float32)
        value = rng.randn(B, S, 256).astype(np.float32)
        g = rng.randn(B, Q, 256).astype(np.float32)
        jm = JaxMSDA(impl=jax_impl, window=6)

        def fwd_bwd(p, q, v, jm=jm, ref=ref, g=g):
            out, vjp = jax.vjp(lambda *a: jm.apply({"params": a[0]}, a[1], ref, a[2], SHAPES),
                               p, q, v)
            return out, vjp(g)

        refs[jax_impl] = (p, ref, query, value, g, *jax.jit(fwd_bwd)(p, query, value))
    return refs


@pytest.mark.parametrize("impl", ["pallas", "sepwin", "windowed", "dense", "dense_fused"])
def test_msda_optin_impl(weights, msda_references, impl):
    """MSDeformAttn(impl) against the JAX module on the same params, which
    load from the state_dict that params_from_jax made: the windowed impls
    against JAX 'windowed' on the encoder's grid queries, 'dense' and
    'dense_fused' against JAX 'dense' on decoder queries.  Forward, and the
    gradients of the inputs and of every parameter; a parameter's gradient
    sums over up to B * S = 1360 tokens, so its atol is 1e-5 * max|grad|
    (summation order)."""
    _, model = weights
    windowed = impl in ("pallas", "sepwin", "windowed")
    p, ref, query, value, g, want, (want_p, want_q, want_v) = msda_references[
        "windowed" if windowed else "dense"]
    m = MSDeformAttn(impl=impl, window=6)
    prefix = ("depthaware_transformer.encoder.layers.0.self_attn." if windowed
              else "depthaware_transformer.decoder.layers.0.cross_attn.")
    m.load_state_dict({k[len(prefix):]: v for k, v in model.state_dict().items()
                       if k.startswith(prefix)})
    with torch.no_grad():
        m.sampling_offsets.weight.copy_(t(p["sampling_offsets"]["kernel"]).T)
        m.sampling_offsets.bias.copy_(t(p["sampling_offsets"]["bias"]))
    q_t, v_t = t(query).requires_grad_(True), t(value).requires_grad_(True)
    got = m(q_t, t(ref), v_t, SHAPES)
    (got * t(g)).sum().backward()
    close(got.detach(), want)
    close(q_t.grad, want_q)
    close(v_t.grad, want_v)
    for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
        lin = getattr(m, name)
        for a, b in ((lin.weight.grad.T, want_p[name]["kernel"]),
                     (lin.bias.grad, want_p[name]["bias"])):
            close(a, b, atol=1e-5 * np.abs(np.asarray(b)).max())


def test_one_state_dict_loads_into_every_impl(weights):
    """The parameters keep the reference layout under every impl: the
    state_dict that params_from_jax made loads, strictly, into the model
    built with each encoder and decoder impl."""
    _, model = weights
    sd = model.state_dict()
    for enc in ("gather", "fused", "pallas", "sepwin", "windowed"):
        for dec in ("gather", "sep", "dense", "dense_fused"):
            tm = build_monodetr(dict(CFG, msda_impl=enc, dec_msda_impl=dec))
            tm.load_state_dict(sd)
            assert tm.state_dict().keys() == sd.keys()


def test_mlp_head(weights):
    params, model = weights
    x = np.random.RandomState(9).randn(B, 50, 256).astype(np.float32)
    want = JaxMLP(256, 6, 3).apply({"params": params["bbox_embed_0"]}, x)
    with torch.no_grad():
        got = model.bbox_embed[0](t(x))
    close(got, want)


@pytest.fixture(scope="module")
def jax_forwards():
    """JAX eval forwards by (msda_impl, dec_msda_impl), each compiled once."""
    return {}


@pytest.mark.parametrize("impls", [("fused", "sep"), ("gather", "gather"),
                                   ("pallas", "dense_fused"), ("sepwin", "dense"),
                                   ("windowed", "sep")])
def test_eval_forward_matches_jax(weights, jax_forwards, impls):
    """The whole eval forward: port (impls) against JAX on the same
    weights; tolerance 1e-3.  JAX runs 'windowed' for every windowed port
    impl (the Pallas kernels have no fast CPU path) and 'dense' for
    'dense_fused' (its own CPU path, msda_module.py:270)."""
    params, model = weights
    enc, dec = impls
    jax_impls = ("windowed" if enc in ("fused", "pallas", "sepwin") else enc,
                 "dense" if dec == "dense_fused" else dec)
    images, calibs, sizes = inputs()
    if jax_impls not in jax_forwards:
        jm = jax_build(dict(CFG, msda_impl=jax_impls[0], dec_msda_impl=jax_impls[1]))
        jax_forwards[jax_impls] = jax.jit(
            lambda p: jm.apply({"params": p}, images, calibs, sizes, train=False))(params)
    want = jax_forwards[jax_impls]
    tm = build_monodetr(dict(CFG, msda_impl=enc, dec_msda_impl=dec))
    tm.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = tm(t(images), t(calibs), t(sizes))
    for k in ("pred_logits", "pred_boxes", "pred_3d_dim", "pred_depth", "pred_angle",
              "pred_depth_map_logits", "weighted_depth"):
        close(got[k], want[k], rtol=1e-3, atol=1e-3)
        assert np.isfinite(got[k].numpy()).all()
    for ga, wa in zip(got["aux_outputs"], want["aux_outputs"]):
        close(ga["pred_boxes"], wa["pred_boxes"], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("remat, outcome", [
    (False, "builds"), ("none", "builds"), ("backbone", "builds"), ("encoder", "builds"),
    (True, "builds"), ("all", "builds"),
    ("decoder", ValueError), ("Encoder", ValueError), (None, ValueError)])
def test_remat_is_validated_as_the_jax_model_does(remat, outcome):
    """The JAX model takes remat False / 'none' / 'backbone' / 'encoder' /
    True / 'all' and raises ValueError on anything else; the port builds
    every value the JAX model takes, with the same scopes (the backbone's
    blocks and the encoder's layers flagged as the JAX model's
    _remat_in says), and raises the JAX model's ValueError for the rest."""
    tiny = dict(CFG, enc_layers=1, dec_layers=1, remat=remat)
    jax_model = jax_build(dict(tiny, dtype="fp32"))
    if outcome is ValueError:
        with pytest.raises(ValueError) as jax_err:
            jax_model._remat_in("encoder")
        with pytest.raises(ValueError) as err:
            build_monodetr(tiny)
        assert str(err.value) == str(jax_err.value)
    else:
        model = build_monodetr(tiny)
        assert model.dec_layers == 1
        assert model.backbone[0].body.remat == jax_model._remat_in("backbone")
        assert ([layer.remat for layer in model.depthaware_transformer.encoder.layers]
                == [jax_model._remat_in("encoder")])
