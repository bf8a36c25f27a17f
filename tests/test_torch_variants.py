"""The stress configuration's model variants in monodetr_torch against
monodetr_tpu, in f32 on the CPU: `backbone: resnet101`, `dilation: True`
and `position_embedding: learned` (alias `v3`).

- LearnedPositionEmbedding against the JAX module at several sizes (the
  same tables): rtol 1e-6, atol 1e-6 (the same f32 interpolation);
- the ResNet-101 backbone and the dilated ResNet-50 backbone (64x128,
  B=1) against the JAX ResNetBackbone: rtol 1e-4, atol 1e-4, as
  tests/test_torch_model.py holds ResNet-50 (33 bottlenecks deep, the same
  bound holds);
- one eval forward of resnet101 + dilation + learned at 128x256, 2 + 2
  layers, against MonoDETR.apply: 1e-3, as the shipped model is held.
  With dilation the pyramid is (16, 32), (8, 16), (8, 16), (4, 8): two
  equal levels.  JAX runs 'windowed' for the port's 'fused' (its CPU path;
  ROADMAP.md C4);
- the state_dict made by convert.params_from_jax loads into the port and
  train/checkpoint.py:to_jax_tree gives the tree back (ResNet-101's 23
  blocks of layer3, the learned tables under position_embedding);
- the refusals: an unknown backbone or position embedding raises
  ValueError.  (The query variants are held by
  tests/test_torch_query_variants.py.)
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
from monodetr_tpu.models.position_encoding import (  # noqa: E402
    LearnedPositionEmbedding as JaxLearned)
from monodetr_torch.convert import LEARNED_POSITION, params_from_jax  # noqa: E402
from monodetr_torch.models.backbone import ResNetBackbone  # noqa: E402
from monodetr_torch.models.monodetr import build_monodetr  # noqa: E402
from monodetr_torch.models.position_encoding import LearnedPositionEmbedding  # noqa: E402
from monodetr_torch.train.checkpoint import to_jax_tree  # noqa: E402

torch.set_num_threads(2)
CFG = dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep", dtype="float32",
           enc_layers=2, dec_layers=2, backbone="resnet101", dilation=True,
           position_embedding="learned")


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def randomised(model, seed=0):
    """The model's state_dict as numpy with random FrozenBN statistics and
    sampling-offset / attention-weight kernels (as tests/test_torch_model.py
    makes them): samples move and some leave the window."""
    rng = np.random.RandomState(seed)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    for k, v in sd.items():
        if k.endswith("running_var") or (".bn" in k and k.endswith("weight")):
            sd[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        elif k.endswith("running_mean") or (".bn" in k and k.endswith("bias")):
            sd[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("sampling_offsets.weight"):
            sd[k] = (rng.randn(*v.shape) * 0.03).astype(np.float32)
        elif k.endswith("attention_weights.weight"):
            sd[k] = (rng.randn(*v.shape) * 0.05).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port model loaded through params_from_jax) for CFG."""
    sd = randomised(build_monodetr(CFG, seed=0))
    tree = convert_state_dict(sd, backbone="resnet101", enc_layers=2, dec_layers=2)
    tree["params"]["position_embedding"] = {
        "row_embed": sd[LEARNED_POSITION[0]], "col_embed": sd[LEARNED_POSITION[1]]}
    model = build_monodetr(CFG)
    model.load_state_dict(params_from_jax(tree))
    return tree["params"], model


@pytest.mark.parametrize("h,w", [(16, 32), (8, 16), (3, 5), (50, 50), (96, 320), (61, 7)])
def test_learned_position_embedding_matches_jax(h, w):
    rng = np.random.RandomState(h * w)
    row, col = (rng.rand(50, 128).astype(np.float32) for _ in range(2))
    want = JaxLearned(128).apply({"params": {"row_embed": row, "col_embed": col}}, h, w)
    m = LearnedPositionEmbedding(128)
    with torch.no_grad():
        m.row_embed.weight.copy_(torch.from_numpy(row))
        m.col_embed.weight.copy_(torch.from_numpy(col))
        got = m(h, w)
    assert got.shape == (h, w, 256) and got.dtype == torch.float32
    close(got, want, 1e-6, 1e-6)


def test_learned_position_init_is_uniform():
    m = build_monodetr(dict(CFG, enc_layers=1, dec_layers=1), seed=3).backbone[1]
    for table in (m.row_embed.weight, m.col_embed.weight):
        assert table.shape == (50, 128) and 0 <= table.min() and table.max() < 1
        assert 0.4 < table.mean() < 0.6


@pytest.mark.parametrize("name,dilation", [("resnet101", False), ("resnet50", True)])
def test_backbone_matches_jax(name, dilation):
    model = build_monodetr(dict(CFG, backbone=name, dilation=dilation, enc_layers=1,
                                dec_layers=1), seed=0)
    sd = randomised(model, seed=1)
    params = convert_state_dict(sd, backbone=name, enc_layers=1, dec_layers=1)["params"]
    bb = ResNetBackbone(name, dilation)
    bb.load_state_dict({k[len("backbone.0."):]: torch.from_numpy(v) for k, v in sd.items()
                        if k.startswith("backbone.0.")})
    images = np.random.RandomState(2).randn(1, 64, 128, 3).astype(np.float32)
    want = jax.jit(lambda p, x: JaxBackbone(name, dilation).apply({"params": p}, x))(
        params["backbone"], images)
    with torch.no_grad():
        got = bb(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert [tuple(g.shape[2:]) for g in got] == [(8, 16), (4, 8), (4 if dilation else 2,
                                                                   8 if dilation else 4)]
    for g, w in zip(got, want):
        close(g.permute(0, 2, 3, 1), w, 1e-4, 1e-4)
    assert len(bb.body.layer3) == (23 if name == "resnet101" else 6)


def test_eval_forward_matches_jax(weights):
    params, model = weights
    rng = np.random.RandomState(1)
    B = 2
    images = rng.randn(B, 128, 256, 3).astype(np.float32)
    calibs = np.tile(np.array([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                              np.float32), (B, 1, 1))
    calibs[1, 0, 0] = 650.0
    sizes = np.tile(np.array([[1242.0, 375.0]], np.float32), (B, 1))
    jm = jax_build(dict(CFG, msda_impl="windowed"))
    want = jax.jit(lambda p: jm.apply({"params": p}, images, calibs, sizes, train=False))(params)
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in (images, calibs, sizes)))
    for k in ("pred_logits", "pred_boxes", "pred_3d_dim", "pred_depth", "pred_angle",
              "pred_depth_map_logits", "weighted_depth"):
        close(got[k], want[k], 1e-3, 1e-3)
        assert np.isfinite(got[k].numpy()).all()
    for ga, wa in zip(got["aux_outputs"], want["aux_outputs"]):
        close(ga["pred_boxes"], wa["pred_boxes"], 1e-3, 1e-3)


def test_checkpoint_tree_round_trip(weights):
    params, model = weights
    tree = to_jax_tree(model)
    assert sorted(tree["params"]) == sorted(params)
    assert len([k for k in tree["params"]["backbone"] if k.startswith("layer3_")]) == 23
    back = params_from_jax(tree)
    for k, v in model.state_dict().items():
        if "running" not in k and not k.endswith((".bn1.weight", ".bn2.weight", ".bn3.weight")):
            assert torch.equal(back[k], v), k
    np.testing.assert_array_equal(tree["params"]["position_embedding"]["row_embed"],
                                  model.backbone[1].row_embed.weight.detach().numpy())


@pytest.mark.parametrize("key,value", [("backbone", "resnet34"),
                                       ("position_embedding", "sinusoid")])
def test_unknown_backbone_or_position_is_refused(key, value):
    with pytest.raises(ValueError, match=value):
        build_monodetr(dict(CFG, enc_layers=1, dec_layers=1, **{key: value}))


def test_v3_is_the_learned_embedding():
    m = build_monodetr(dict(CFG, enc_layers=1, dec_layers=1, position_embedding="v3"))
    assert isinstance(m.backbone[1], LearnedPositionEmbedding)
    assert len(build_monodetr(dict(CFG, enc_layers=1, dec_layers=1,
                                   position_embedding="sine")).backbone) == 1
