"""Parameter layouts, both directions: the reference's `state_dict` and the
JAX package's flax tree.

`convert_state_dict` (reference or monodetr_torch state_dict -> flax tree)
and `convert_torchvision_backbone` (a plain torchvision ResNet state dict
-> the backbone-only partial tree that `trainer.pretrain_model` merges
into the init) are the port's own copies of tools/convert_checkpoint.py's,
numpy only, computing the same arrays; tools/convert_checkpoint_torch.py
is their command line, and train/checkpoint.py saves every checkpoint
through them.

`params_from_jax` is the inverse of convert_state_dict for every query
configuration (standard, two_stage, use_dab, two_stage_dino): it takes
the flax tree (numpy arrays, as the JAX checkpoints pickle them) and
returns tensors under the reference `state_dict` names that monodetr_torch
uses.  The tree's configuration (query_configuration) decides which query
tables and layers are read: the decoder's ref_point_head and query_scale
(use_dab, two_stage_dino), the proposal layers, and for two_stage one class
and bbox head more than the size, angle and depth heads.

  - flax Dense kernel [in, out] <-> Linear weight [out, in];
  - flax Conv kernel [kh, kw, I, O] <-> Conv2d weight [O, I, kh, kw];
  - FrozenBN's four buffers fold into the JAX (scale, bias): scale = w /
    sqrt(rv + eps), bias = b - rm * scale (the reference's
    backbone.py:62-64); back, weight = scale, bias = bias,
    running_mean = 0 and running_var = 1 - eps, which define the same
    affine;
  - MultiheadAttention in_proj_weight [3C, C] <-> in_proj_kernel [C, 3C];
  - the learned position tables (position_embedding/row_embed, col_embed,
    [50, F]) -> backbone.1.row_embed.weight, backbone.1.col_embed.weight,
    the reference's Joiner names (convert_state_dict has no mapping for
    them; train/checkpoint.py adds them);
  - the reference's dead parameters (sa_v_proj, overwritten at
    depthaware_transformer.py:477; label_enc, DN only) are skipped.
The backbone's blocks are counted per stage (ResNet-50 or ResNet-101).
Every leaf of the tree must be consumed by params_from_jax: an unknown
leaf raises.
"""

import numpy as np
import torch

from .models.backbone import BN_EPS

# the learned position embedding's tables, as the reference names them
LEARNED_POSITION = ("backbone.1.row_embed.weight", "backbone.1.col_embed.weight")


class _Tree:
    """Reads leaves of the nested dict by path and remembers which."""

    def __init__(self, tree):
        self.tree = tree
        self.used = set()

    def get(self, path):
        node = self.tree
        for k in path.split("/"):
            node = node[k]
        self.used.add(path)
        return np.asarray(node, np.float32)

    def has(self, path):
        node = self.tree
        for k in path.split("/"):
            if not isinstance(node, dict) or k not in node:
                return False
            node = node[k]
        return True

    def unused(self, node=None, prefix=""):
        node = self.tree if node is None else node
        for k, v in node.items():
            path = prefix + k
            if isinstance(v, dict):
                yield from self.unused(v, path + "/")
            elif path not in self.used:
                yield path


def query_configuration(flax_params):
    """'standard', 'two_stage', 'use_dab' or 'two_stage_dino': the query
    configuration whose layers the tree holds."""
    if "params" in flax_params:
        flax_params = flax_params["params"]
    tr = flax_params["transformer"]
    if "pos_trans" in tr:
        return "two_stage"
    if "enc_out_class_embed" in tr:
        return "two_stage_dino"
    return "use_dab" if "refpoint_embed" in flax_params else "standard"


def params_from_jax(flax_params) -> dict:
    """flax params (with or without the top-level 'params' key) ->
    state_dict of torch tensors for monodetr_torch.models.MonoDETR."""
    if "params" in flax_params:
        flax_params = flax_params["params"]
    t = _Tree(flax_params)
    sd = {}

    def lin(torch_prefix, path):
        sd[torch_prefix + ".weight"] = t.get(path + "/kernel").T
        sd[torch_prefix + ".bias"] = t.get(path + "/bias")

    def conv(torch_prefix, path, bias=True):
        sd[torch_prefix + ".weight"] = t.get(path + "/kernel").transpose(3, 2, 0, 1)
        if bias:
            sd[torch_prefix + ".bias"] = t.get(path + "/bias")

    def frozen_bn(torch_prefix, path):
        scale = t.get(path + "/scale")
        sd[torch_prefix + ".weight"] = scale
        sd[torch_prefix + ".bias"] = t.get(path + "/bias")
        sd[torch_prefix + ".running_mean"] = np.zeros_like(scale)
        sd[torch_prefix + ".running_var"] = np.full_like(scale, 1.0 - BN_EPS)

    def norm(torch_prefix, path):
        sd[torch_prefix + ".weight"] = t.get(path + "/scale")
        sd[torch_prefix + ".bias"] = t.get(path + "/bias")

    def mha(torch_prefix, path):
        sd[torch_prefix + ".in_proj_weight"] = t.get(path + "/in_proj_kernel").T
        sd[torch_prefix + ".in_proj_bias"] = t.get(path + "/in_proj_bias")
        lin(torch_prefix + ".out_proj", path + "/out_proj")

    def mlp(torch_prefix, path):
        i = 0
        while t.has(f"{path}/layers_{i}"):
            lin(f"{torch_prefix}.layers.{i}", f"{path}/layers_{i}")
            i += 1

    def msda(torch_prefix, path):
        for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            lin(f"{torch_prefix}.{name}", f"{path}/{name}")

    def conv_gn(torch_conv, torch_gn, path):
        conv(torch_conv, path + "/conv")
        norm(torch_gn, path + "/gn")

    def count(prefix, path=""):
        n = 0
        while t.has(f"{path}{prefix}{n}"):
            n += 1
        return n

    # ---- backbone ----
    bb = "backbone.0.body."
    conv(bb + "conv1", "backbone/conv1", bias=False)
    frozen_bn(bb + "bn1", "backbone/bn1")
    for stage in range(1, 5):
        for b in range(count(f"layer{stage}_", "backbone/")):
            tp, jp = f"{bb}layer{stage}.{b}", f"backbone/layer{stage}_{b}"
            for i in (1, 2, 3):
                conv(f"{tp}.conv{i}", f"{jp}/conv{i}", bias=False)
                frozen_bn(f"{tp}.bn{i}", f"{jp}/bn{i}")
            if t.has(jp + "/downsample_conv"):
                conv(f"{tp}.downsample.0", jp + "/downsample_conv", bias=False)
                frozen_bn(f"{tp}.downsample.1", jp + "/downsample_bn")

    if t.has("position_embedding"):
        for key, name in zip(LEARNED_POSITION, ("row_embed", "col_embed")):
            sd[key] = t.get("position_embedding/" + name)
    for i in range(4):
        conv_gn(f"input_proj.{i}.0", f"input_proj.{i}.1", f"input_proj_{i}")

    # ---- depth predictor ----
    dp, jd = "depth_predictor.", "depth_predictor/"
    for name in ("proj", "upsample", "downsample"):
        conv_gn(f"{dp}{name}.0", f"{dp}{name}.1", jd + name)
    conv_gn(dp + "depth_head.0", dp + "depth_head.1", jd + "depth_head_0")
    conv_gn(dp + "depth_head.3", dp + "depth_head.4", jd + "depth_head_1")
    conv(dp + "depth_classifier", jd + "depth_classifier")
    enc, je = dp + "depth_encoder.layers.0.", jd + "depth_encoder/"
    mha(enc + "self_attn", je + "self_attn")
    for name in ("norm1", "norm2"):
        norm(enc + name, je + name)
    for name in ("linear1", "linear2"):
        lin(enc + name, je + name)
    sd[dp + "depth_pos_embed.weight"] = t.get(jd + "depth_pos_embed")

    # ---- transformer ----
    tr, jt = "depthaware_transformer.", "transformer/"
    sd[tr + "level_embed"] = t.get(jt + "level_embed")
    for i in range(count("encoder_layer_", jt)):
        e, je = f"{tr}encoder.layers.{i}.", f"{jt}encoder_layer_{i}/"
        msda(e + "self_attn", je + "self_attn")
        norm(e + "norm1", je + "norm1")
        lin(e + "linear1", je + "ffn/linear1")
        lin(e + "linear2", je + "ffn/linear2")
        norm(e + "norm2", je + "ffn/norm")
    for i in range(count("decoder_layer_", jt)):
        d, jl = f"{tr}decoder.layers.{i}.", f"{jt}decoder_layer_{i}/"
        msda(d + "cross_attn", jl + "cross_attn")
        mha(d + "cross_attn_depth", jl + "cross_attn_depth")
        mha(d + "self_attn", jl + "self_attn")
        for name in ("norm1", "norm_depth", "norm2"):
            norm(d + name, jl + name)
        for name in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj", "sa_kpos_proj"):
            lin(d + name, jl + name)
        lin(d + "linear1", jl + "ffn/linear1")
        lin(d + "linear2", jl + "ffn/linear2")
        norm(d + "norm3", jl + "ffn/norm")

    # ---- the query configuration's own layers and the heads ----
    variant = query_configuration(flax_params)
    if variant == "standard":
        lin(tr + "reference_points", jt + "reference_points")
        sd["query_embed.weight"] = t.get("query_embed")
    if variant in ("use_dab", "two_stage_dino"):
        for name in ("ref_point_head", "query_scale"):
            mlp(f"{tr}decoder.{name}", jt + name)
    if variant in ("two_stage", "two_stage_dino"):
        lin(tr + "enc_output", jt + "enc_output")
        norm(tr + "enc_output_norm", jt + "enc_output_norm")
    if variant == "two_stage":
        lin(tr + "pos_trans", jt + "pos_trans")
        norm(tr + "pos_trans_norm", jt + "pos_trans_norm")
    elif variant == "two_stage_dino":
        lin(tr + "enc_out_class_embed", jt + "enc_out_class_embed")
        mlp(tr + "enc_out_bbox_embed", jt + "enc_out_bbox_embed")
        sd[tr + "tgt_embed.weight"] = t.get(jt + "tgt_embed")
    elif variant == "use_dab":
        for name in ("tgt_embed", "refpoint_embed"):
            sd[name + ".weight"] = t.get(name)
    # two_stage's extra head set scores the proposals with class and bbox
    n_pred = count("class_embed_")
    for i in range(n_pred):
        lin(f"class_embed.{i}", f"class_embed_{i}")
        mlp(f"bbox_embed.{i}", f"bbox_embed_{i}")
        if i < n_pred - (variant == "two_stage"):
            for name in ("dim_embed_3d", "angle_embed", "depth_embed"):
                mlp(f"{name}.{i}", f"{name}_{i}")

    left = sorted(t.unused())
    if left:
        raise KeyError(f"params_from_jax: leaves with no counterpart in the "
                       f"{variant} configuration: {left[:8]}")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


# ---- reference state_dict -> flax tree (tools/convert_checkpoint.py) ----

def _lin(sd, torch_prefix):
    """torch Linear -> {kernel, bias}."""
    return {
        "kernel": np.ascontiguousarray(sd[torch_prefix + ".weight"].T),
        "bias": np.asarray(sd[torch_prefix + ".bias"]),
    }


def _conv(sd, torch_prefix, bias=True):
    out = {
        "kernel": np.ascontiguousarray(
            np.transpose(sd[torch_prefix + ".weight"], (2, 3, 1, 0))
        )
    }
    if bias:
        out["bias"] = np.asarray(sd[torch_prefix + ".bias"])
    return out


def _frozen_bn(sd, torch_prefix):
    w = np.asarray(sd[torch_prefix + ".weight"])
    b = np.asarray(sd[torch_prefix + ".bias"])
    rm = np.asarray(sd[torch_prefix + ".running_mean"])
    rv = np.asarray(sd[torch_prefix + ".running_var"])
    scale = w / np.sqrt(rv + BN_EPS)
    return {"scale": scale, "bias": b - rm * scale}


def _norm(sd, torch_prefix):
    """torch LayerNorm/GroupNorm -> {scale, bias}."""
    return {
        "scale": np.asarray(sd[torch_prefix + ".weight"]),
        "bias": np.asarray(sd[torch_prefix + ".bias"]),
    }


def _mha(sd, torch_prefix):
    """torch nn.MultiheadAttention -> the JAX MultiheadAttention params."""
    return {
        "in_proj_kernel": np.ascontiguousarray(sd[torch_prefix + ".in_proj_weight"].T),
        "in_proj_bias": np.asarray(sd[torch_prefix + ".in_proj_bias"]),
        "out_proj": _lin(sd, torch_prefix + ".out_proj"),
    }


def _mlp(sd, torch_prefix, n_layers):
    return {f"layers_{i}": _lin(sd, f"{torch_prefix}.layers.{i}") for i in range(n_layers)}


def _msda(sd, torch_prefix):
    return {
        "sampling_offsets": _lin(sd, torch_prefix + ".sampling_offsets"),
        "attention_weights": _lin(sd, torch_prefix + ".attention_weights"),
        "value_proj": _lin(sd, torch_prefix + ".value_proj"),
        "output_proj": _lin(sd, torch_prefix + ".output_proj"),
    }


def _bottleneck(sd, torch_prefix, has_downsample):
    out = {
        "conv1": _conv(sd, torch_prefix + ".conv1", bias=False),
        "bn1": _frozen_bn(sd, torch_prefix + ".bn1"),
        "conv2": _conv(sd, torch_prefix + ".conv2", bias=False),
        "bn2": _frozen_bn(sd, torch_prefix + ".bn2"),
        "conv3": _conv(sd, torch_prefix + ".conv3", bias=False),
        "bn3": _frozen_bn(sd, torch_prefix + ".bn3"),
    }
    if has_downsample:
        out["downsample_conv"] = _conv(sd, torch_prefix + ".downsample.0", bias=False)
        out["downsample_bn"] = _frozen_bn(sd, torch_prefix + ".downsample.1")
    return out


def _conv_gn(sd, conv_prefix, gn_prefix):
    return {"conv": _conv(sd, conv_prefix), "gn": _norm(sd, gn_prefix)}


STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


def convert_state_dict(sd, backbone="resnet50", enc_layers=3, dec_layers=3,
                       two_stage=False, use_dab=False, two_stage_dino=False):
    """torch state_dict (name -> numpy array) -> flax params['params'] dict.

    Variant flags mirror the reference build switches (monodetr.py:69-76,
    123-133; depthaware_transformer.py:108-118): two_stage adds the proposal
    projection + pos_trans and one extra head clone; use_dab swaps
    query_embed for tgt_embed/refpoint_embed; two_stage_dino adds the
    encoder-proposal heads and tgt_embed on the transformer.
    """
    sd = {k: np.asarray(v) for k, v in sd.items()}
    p = {}

    # ---- backbone (reference prefix: backbone.0.body.) ----
    bb = "backbone.0.body."
    bp = {
        "conv1": _conv(sd, bb + "conv1", bias=False),
        "bn1": _frozen_bn(sd, bb + "bn1"),
    }
    for stage, n_blocks in enumerate(STAGE_BLOCKS[backbone]):
        for b in range(n_blocks):
            bp[f"layer{stage + 1}_{b}"] = _bottleneck(
                sd, f"{bb}layer{stage + 1}.{b}", has_downsample=(b == 0)
            )
    p["backbone"] = bp

    # ---- input projections ----
    for i in range(4):
        p[f"input_proj_{i}"] = _conv_gn(
            sd, f"input_proj.{i}.0", f"input_proj.{i}.1"
        )

    # ---- depth predictor ----
    dp = "depth_predictor."
    enc = dp + "depth_encoder.layers.0."
    p["depth_predictor"] = {
        "proj": _conv_gn(sd, dp + "proj.0", dp + "proj.1"),
        "upsample": _conv_gn(sd, dp + "upsample.0", dp + "upsample.1"),
        "downsample": _conv_gn(sd, dp + "downsample.0", dp + "downsample.1"),
        "depth_head_0": _conv_gn(sd, dp + "depth_head.0", dp + "depth_head.1"),
        "depth_head_1": _conv_gn(sd, dp + "depth_head.3", dp + "depth_head.4"),
        "depth_classifier": _conv(sd, dp + "depth_classifier"),
        "depth_encoder": {
            "self_attn": _mha(sd, enc + "self_attn"),
            "norm1": _norm(sd, enc + "norm1"),
            "norm2": _norm(sd, enc + "norm2"),
            "linear1": _lin(sd, enc + "linear1"),
            "linear2": _lin(sd, enc + "linear2"),
        },
        "depth_pos_embed": np.asarray(sd[dp + "depth_pos_embed.weight"]),
    }

    # ---- transformer ----
    tr = "depthaware_transformer."
    tp = {"level_embed": np.asarray(sd[tr + "level_embed"])}
    # the vanilla query path projects query_embed -> initial references;
    # all variants derive references elsewhere (transformer.py:134)
    if not (two_stage or use_dab or two_stage_dino):
        tp["reference_points"] = _lin(sd, tr + "reference_points")
    for i in range(enc_layers):
        e = f"{tr}encoder.layers.{i}."
        tp[f"encoder_layer_{i}"] = {
            "self_attn": _msda(sd, e + "self_attn"),
            "norm1": _norm(sd, e + "norm1"),
            "ffn": {
                "linear1": _lin(sd, e + "linear1"),
                "linear2": _lin(sd, e + "linear2"),
                "norm": _norm(sd, e + "norm2"),
            },
        }
    for i in range(dec_layers):
        d = f"{tr}decoder.layers.{i}."
        tp[f"decoder_layer_{i}"] = {
            "cross_attn": _msda(sd, d + "cross_attn"),
            "norm1": _norm(sd, d + "norm1"),
            "cross_attn_depth": _mha(sd, d + "cross_attn_depth"),
            "norm_depth": _norm(sd, d + "norm_depth"),
            "self_attn": _mha(sd, d + "self_attn"),
            "norm2": _norm(sd, d + "norm2"),
            "sa_qcontent_proj": _lin(sd, d + "sa_qcontent_proj"),
            "sa_qpos_proj": _lin(sd, d + "sa_qpos_proj"),
            "sa_kcontent_proj": _lin(sd, d + "sa_kcontent_proj"),
            "sa_kpos_proj": _lin(sd, d + "sa_kpos_proj"),
            # sa_v_proj is dead in the reference (value = raw tgt) — skipped
            "ffn": {
                "linear1": _lin(sd, d + "linear1"),
                "linear2": _lin(sd, d + "linear2"),
                "norm": _norm(sd, d + "norm3"),
            },
        }
    if use_dab or two_stage_dino:
        # per-layer query-pos MLPs live on the reference decoder
        # (depthaware_transformer.py:530-537); query_scale_bbox is dead
        tp["ref_point_head"] = _mlp(sd, tr + "decoder.ref_point_head", 2)
        tp["query_scale"] = _mlp(sd, tr + "decoder.query_scale", 2)
    if two_stage:
        tp["enc_output"] = _lin(sd, tr + "enc_output")
        tp["enc_output_norm"] = _norm(sd, tr + "enc_output_norm")
        tp["pos_trans"] = _lin(sd, tr + "pos_trans")
        tp["pos_trans_norm"] = _norm(sd, tr + "pos_trans_norm")
    elif two_stage_dino:
        tp["enc_output"] = _lin(sd, tr + "enc_output")
        tp["enc_output_norm"] = _norm(sd, tr + "enc_output_norm")
        tp["tgt_embed"] = np.asarray(sd[tr + "tgt_embed.weight"])
        tp["enc_out_class_embed"] = _lin(sd, tr + "enc_out_class_embed")
        tp["enc_out_bbox_embed"] = _mlp(sd, tr + "enc_out_bbox_embed", 3)
    p["transformer"] = tp

    # ---- queries + heads ----
    if not two_stage and not two_stage_dino:
        if use_dab:
            p["tgt_embed"] = np.asarray(sd["tgt_embed.weight"])
            p["refpoint_embed"] = np.asarray(sd["refpoint_embed.weight"])
        else:
            p["query_embed"] = np.asarray(sd["query_embed.weight"])
    # two-stage scores encoder proposals with one extra head clone
    # (reference num_pred, monodetr.py:123)
    n_pred = dec_layers + 1 if two_stage else dec_layers
    for i in range(n_pred):
        p[f"class_embed_{i}"] = _lin(sd, f"class_embed.{i}")
        p[f"bbox_embed_{i}"] = _mlp(sd, f"bbox_embed.{i}", 3)
        p[f"dim_embed_3d_{i}"] = _mlp(sd, f"dim_embed_3d.{i}", 2)
        p[f"angle_embed_{i}"] = _mlp(sd, f"angle_embed.{i}", 2)
        p[f"depth_embed_{i}"] = _mlp(sd, f"depth_embed.{i}", 2)

    return {"params": p}


def convert_torchvision_backbone(sd, backbone="resnet50"):
    """Plain torchvision resnet50/101 state dict -> backbone-only partial
    params {'params': {'backbone': ...}} for the Trainer's pretrain merge.

    Mirrors the reference's automatic ImageNet init
    (backbone.py:100-102 `torchvision.models.resnet50(pretrained=True)`):
    same key layout minus the 'backbone.0.body.' prefix; BN folds into
    (scale, bias) exactly like FrozenBatchNorm2d; the fc head is dropped.
    """
    sd = {k: np.asarray(v) for k, v in sd.items() if not k.startswith("fc.")}
    bp = {
        "conv1": _conv(sd, "conv1", bias=False),
        "bn1": _frozen_bn(sd, "bn1"),
    }
    for stage, n_blocks in enumerate(STAGE_BLOCKS[backbone]):
        for b in range(n_blocks):
            bp[f"layer{stage + 1}_{b}"] = _bottleneck(
                sd, f"layer{stage + 1}.{b}", has_downsample=(b == 0)
            )
    return {"params": {"backbone": bp}}


def tree_leaves(tree):
    """The arrays of a nested dict, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree
