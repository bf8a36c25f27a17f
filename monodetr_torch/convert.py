"""JAX parameter tree -> monodetr_torch state_dict.

`params_from_jax` is the inverse of tools/convert_checkpoint.py:
convert_state_dict for every query configuration (standard, two_stage,
use_dab, two_stage_dino): it takes the flax tree (numpy arrays, as the JAX
checkpoints pickle them) and returns tensors under the reference
`state_dict` names that monodetr_torch uses.  The tree's configuration
(query_configuration) decides which query tables and layers are read: the
decoder's ref_point_head and query_scale (use_dab, two_stage_dino), the
proposal layers, and for two_stage one class and bbox head more than the
size, angle and depth heads.

  - flax Dense kernel [in, out] -> Linear weight [out, in];
  - flax Conv kernel [kh, kw, I, O] -> Conv2d weight [O, I, kh, kw];
  - the JAX FrozenBN holds the folded (scale, bias); the four reference
    buffers become weight = scale, bias = bias, running_mean = 0 and
    running_var = 1 - eps, which define the same affine;
  - MultiheadAttention in_proj_kernel [C, 3C] -> in_proj_weight [3C, C];
  - the learned position tables (position_embedding/row_embed, col_embed,
    [50, F]) -> backbone.1.row_embed.weight, backbone.1.col_embed.weight,
    the reference's Joiner names (tools/convert_checkpoint.py has no
    mapping for them).
The backbone's blocks are counted per stage (ResNet-50 or ResNet-101).
Every leaf of the tree must be consumed: an unknown leaf raises.
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
