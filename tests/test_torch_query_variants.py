"""The query variants of monodetr_torch (`two_stage`, `use_dab`,
`two_stage_dino`) against monodetr_tpu, in f32 on the CPU, at 64x128 with
1 encoder and 2 decoder layers, as tests/test_model_variants.py runs them.

Weights: the port's seeded init with random FrozenBN statistics, random
decoder sampling-offset and attention-weight kernels, and encoder offsets
inside the window at odd multiples of 1/32 px (so 'fused' is the function
of JAX's 'gather', which compiles fastest on the CPU); train/checkpoint.py:
to_jax_tree makes the JAX tree and the port loads it back through
convert.params_from_jax.  Both packages run the same weights on the same
numpy inputs.

- the sine embeddings and the encoder proposals against the JAX helpers
  (rtol 1e-6, atol 1e-6), the proposals at the shipped pyramid too, where
  some leave (0.01, 0.99) and are +inf;
- each variant's eval forward against MonoDETR.apply(train=False), every
  output at 1e-3 (rtol and atol, as the shipped model is held), two_stage's
  enc_outputs too;
- each variant's tree: to_jax_tree gives the JAX model's own leaves and
  shapes (MonoDETR.init), params_from_jax maps every one back;
- the structure: two_stage's extra class and bbox head, the bbox-bias init
  of tests/test_model_variants.py:99-130, DAB's query tables take
  gradients, and two variants at once are refused;
- the proposal variants' `proposal_idx`: a forward given its own picks
  repeats itself exactly, one given other picks follows them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monodetr_tpu.models import build_monodetr as jax_build
from monodetr_tpu.models import transformer as jax_transformer
from monodetr_torch.convert import params_from_jax, query_configuration
from monodetr_torch.models import transformer
from monodetr_torch.models.monodetr import build_monodetr
from monodetr_torch.train.checkpoint import load_model_state, to_jax_tree

torch.set_num_threads(2)
B, IMG_H, IMG_W = 2, 64, 128
SHIPPED_LEVELS = ((48, 160), (24, 80), (12, 40), (6, 20))
BASE = dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep", dtype="float32",
            enc_layers=1, dec_layers=2, dropout=0.0)
# two_stage trains at group_num 1 (its 50 proposals do not split into 11
# groups); DINO at 64x128 has 170 tokens, so 10 queries a group
VARIANTS = {"two_stage": dict(two_stage=True, group_num=1),
            "use_dab": dict(use_dab=True),
            "two_stage_dino": dict(two_stage_dino=True, num_queries=10)}
OUT_KEYS = ("pred_logits", "pred_boxes", "pred_3d_dim", "pred_depth", "pred_angle",
            "pred_depth_map_logits", "weighted_depth")


def variant_cfg(variant):
    return dict(BASE, **VARIANTS[variant])


def variant_tree(cfg, seed=0):
    """A JAX tree from the port's seeded init (module docstring)."""
    rng = np.random.RandomState(seed)
    model = build_monodetr(cfg, seed=seed)

    def rand(shape, scale):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)

    with torch.no_grad():
        for name, t in model.state_dict().items():
            enc = ".encoder." in name
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32) + 0.5))
            elif name.endswith("running_mean"):
                t.copy_(rand(t.shape, 0.1))
            elif name.endswith("sampling_offsets.weight"):
                t.copy_(rand(t.shape, 0.0 if enc else 0.03))
            elif name.endswith("sampling_offsets.bias") and enc:
                u = (rng.rand(*t.shape) * 2 - 1) * 1.9
                t.copy_(torch.from_numpy(((np.floor(u * 16) * 2 + 1) / 32).astype(np.float32)))
            elif name.endswith("attention_weights.weight"):
                t.copy_(rand(t.shape, 0.05))
    return to_jax_tree(model)


def port_model(cfg, tree):
    model = build_monodetr(cfg)
    load_model_state(model, tree)
    return model


def inputs(seed=1, batch=B):
    rng = np.random.RandomState(seed)
    images = rng.randn(batch, IMG_H, IMG_W, 3).astype(np.float32)
    calibs = np.tile(np.array([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                              np.float32), (batch, 1, 1))
    calibs[-1, 0, 0] = 650.0
    sizes = np.tile(np.array([[1242.0, 375.0]], np.float32), (batch, 1))
    return images, calibs, sizes


def close(got, want, rtol=1e-3, atol=1e-3, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("dims", [2, 6])
def test_sine_embedding_matches_jax(dims):
    pos = np.random.RandomState(dims).rand(2, 7, dims).astype(np.float32)
    want = jax_transformer.gen_sineembed_for_position(jnp.asarray(pos))
    got = transformer.gen_sineembed_for_position(torch.from_numpy(pos))
    assert got.shape == (2, 7, 128 * dims)
    close(got, want, 1e-6, 1e-6)


def test_proposal_embedding_matches_jax():
    props = (np.random.RandomState(3).randn(2, 9, 4) * 2).astype(np.float32)
    want = jax_transformer.get_proposal_pos_embed(jnp.asarray(props))
    got = transformer.get_proposal_pos_embed(torch.from_numpy(props))
    assert got.shape == (2, 9, 512)
    close(got, want, 1e-6, 1e-6)


@pytest.mark.parametrize("levels", [((8, 16), (4, 8), (2, 4), (1, 2)), SHIPPED_LEVELS])
def test_encoder_proposals_match_jax(levels):
    unact, valid = transformer.encoder_output_proposals(levels)
    want_unact, want_valid = jax_transformer.encoder_output_proposals(levels)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(unact, want_unact)
    assert unact.shape == (sum(h * w for h, w in levels), 6)
    # at the shipped size columns with x < 0.01 or > 0.99 leave (0.01, 0.99):
    # two at each side of the finest level, one of the next
    assert (~valid).sum() == (0 if levels[0] == (8, 16) else 4 * 48 + 2 * 24)
    assert np.isinf(unact[~valid]).all() and np.isfinite(unact[valid]).all()


@pytest.fixture(scope="module")
def trees():
    return {v: variant_tree(variant_cfg(v)) for v in VARIANTS}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_forward_matches_jax(trees, variant):
    cfg = variant_cfg(variant)
    tree = trees[variant]
    images, calibs, sizes = inputs()
    jm = jax_build(dict(cfg, msda_impl="gather"))
    want = jax.jit(lambda p: jm.apply(p, images, calibs, sizes, train=False))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    model = port_model(cfg, tree)
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in (images, calibs, sizes)))
    nq = cfg.get("num_queries", 50)
    assert got["pred_logits"].shape == (B, nq, 3)
    for k in OUT_KEYS:
        assert np.isfinite(got[k].numpy()).all(), k
        close(got[k], want[k], msg=k)
    assert len(got["aux_outputs"]) == len(want["aux_outputs"]) == 1
    for k in ("pred_logits", "pred_boxes", "pred_depth"):
        close(got["aux_outputs"][0][k], want["aux_outputs"][0][k], msg="aux " + k)
    assert ("enc_outputs" in got) == ("enc_outputs" in want) == (variant == "two_stage")
    if variant == "two_stage":
        S = sum((IMG_H // s) * (IMG_W // s) for s in (8, 16, 32, 64))
        for k in ("pred_logits", "pred_boxes"):
            assert got["enc_outputs"][k].shape == (B, S, 3 if k == "pred_logits" else 6)
            close(got["enc_outputs"][k], want["enc_outputs"][k], msg="enc " + k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_checkpoint_tree_is_the_jax_models_own(trees, variant):
    cfg = variant_cfg(variant)
    tree = trees[variant]
    images, calibs, sizes = inputs()
    jm = jax_build(dict(cfg, msda_impl="gather"))
    init = jax.eval_shape(lambda r: jm.init(r, images, calibs, sizes, train=False),
                          jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), init)
    assert jax.tree_util.tree_map(np.shape, tree) == shapes
    assert query_configuration(tree) == variant
    model = port_model(cfg, tree)
    back = to_jax_tree(model)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree_util.tree_leaves(back)) > 300
    for path, leaf in flat:
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, leaf, rtol=1e-6, atol=1e-7, err_msg=str(path))
    with pytest.raises(KeyError, match=variant):
        params_from_jax({"params": dict(tree["params"], label_enc=np.zeros(3))})


def test_two_stage_has_an_extra_class_and_bbox_head():
    cfg = dict(variant_cfg("two_stage"))
    model = build_monodetr(cfg)
    assert len(model.class_embed) == len(model.bbox_embed) == cfg["dec_layers"] + 1
    assert len(model.dim_embed_3d) == len(model.angle_embed) == cfg["dec_layers"]
    names = set(model.state_dict())
    assert {"depthaware_transformer.pos_trans.weight",
            "depthaware_transformer.enc_output.weight"} <= names
    assert not any(n.startswith(("query_embed", "depthaware_transformer.reference_points"))
                   for n in names)


@pytest.mark.parametrize("case", ["refine", "init_box", "two_stage"])
def test_bbox_head_init_matches_the_jax_models(case):
    """Head 0's last bias is [0, 0, -2, -2, -2, -2] with box refine and the
    later heads' zero; init_box zeroes the last kernel; two_stage leaves
    bias[2:] of every head at 0 (monodetr.py:167-178)."""
    kw = {"refine": {}, "init_box": {"init_box": True}, "two_stage": VARIANTS["two_stage"]}
    model = build_monodetr(dict(BASE, **kw[case]), seed=0)
    lasts = [h.layers[-1] for h in model.bbox_embed]
    want0 = np.zeros(6) if case == "two_stage" else [0, 0, -2, -2, -2, -2]
    np.testing.assert_array_equal(lasts[0].bias.detach().numpy(), want0)
    for last in lasts[1:]:
        np.testing.assert_array_equal(last.bias.detach().numpy(), np.zeros(6))
    assert (lasts[0].weight.abs().max() == 0) == (case == "init_box")
    assert len(lasts) == (3 if case == "two_stage" else 2)
    for head in model.class_embed:
        np.testing.assert_allclose(head.bias.detach().numpy(), -np.log(99.0), rtol=1e-6)


def test_dab_query_tables_take_gradients():
    model = build_monodetr(variant_cfg("use_dab"), seed=0)
    images, calibs, sizes = inputs()
    out = model(*(torch.from_numpy(x) for x in (images, calibs, sizes)))
    (out["pred_boxes"].sum() + out["pred_logits"].sum()).backward()
    for table in (model.refpoint_embed.weight, model.tgt_embed.weight):
        assert table.shape[0] == 550 and torch.isfinite(table.grad).all()
        assert table.grad[:50].abs().sum() > 0 and table.grad[50:].abs().sum() == 0


@pytest.mark.parametrize("variant", ["two_stage", "two_stage_dino"])
def test_proposal_idx_pins_the_picks(trees, variant):
    cfg = variant_cfg(variant)
    model = port_model(cfg, trees[variant])
    x = [torch.from_numpy(a) for a in inputs()]
    with torch.no_grad():
        out = model(*x, train=True)
        idx = out["proposal_idx"]
        again = model(*x, train=True, proposal_idx=idx)
        flipped = model(*x, train=True, proposal_idx=idx.flip(1))
    assert idx.shape == (B, cfg.get("num_queries", 50) * (11 if variant == "two_stage_dino" else 1))
    assert torch.equal(again["proposal_idx"], idx)
    for k in OUT_KEYS:
        assert torch.equal(again[k], out[k]), k
    assert torch.equal(flipped["proposal_idx"], idx.flip(1))
    # the queries follow the picks: the decoder's first reference points
    # are the picked proposals in the order given
    assert not torch.allclose(flipped["pred_boxes"], out["pred_boxes"])
    if variant == "two_stage":  # its queries are the proposals' own embeddings
        torch.testing.assert_close(flipped["pred_boxes"], out["pred_boxes"].flip(1))


def test_two_variants_at_once_are_refused():
    with pytest.raises(ValueError, match="at most one"):
        build_monodetr(dict(BASE, two_stage=True, use_dab=True))
