"""Checkpoints in the JAX package's format (monodetr_tpu/train/checkpoint.py,
reference save_helper.py:13-28): a pickle of

    {epoch, model_state, optimizer_state, best_result, best_epoch}

with numpy leaves.  `model_state` is the flax parameter tree, made from the
model's state_dict by convert.convert_state_dict (numpy only) and read back
by convert.params_from_jax; `optimizer_state` is a
plain dict {step, m, v} whose moment trees have the same layout (the
FrozenBN entries and the frozen stem and layer1, which have no moments,
hold zeros).  So the JAX package can load what the port saves.
"""

import os
import pickle

import numpy as np

from ..convert import LEARNED_POSITION, convert_state_dict, params_from_jax
from ..models.backbone import BN_EPS, FrozenBatchNorm2d


def _layout(model):
    """convert_state_dict's arguments for the model: depths and the query
    configuration."""
    tr = model.depthaware_transformer
    return dict(backbone=model.backbone[0].body.name, enc_layers=len(tr.encoder.layers),
                dec_layers=len(tr.decoder.layers), two_stage=tr.two_stage,
                use_dab=tr.use_dab, two_stage_dino=tr.two_stage_dino)


# heads that the extra set of two_stage lacks in the JAX tree (flax makes
# the parameters of a called head only; the proposals read class and bbox)
UNCALLED_EXTRA_HEADS = ("dim_embed_3d", "angle_embed", "depth_embed")


def _frozen_bn_names(model):
    return {n for n, m in model.named_modules() if isinstance(m, FrozenBatchNorm2d)}


def to_jax_tree(model, values=None):
    """The model's state_dict as a flax tree; with `values` (parameter
    name -> tensor, e.g. an optimizer moment), those tensors in the same
    layout, zeros elsewhere."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    if values is not None:
        bns = _frozen_bn_names(model)
        for k, v in sd.items():
            if k in values:
                sd[k] = values[k].detach().float().cpu().numpy()
            elif k.rsplit(".", 1)[0] in bns and k.endswith("running_var"):
                sd[k] = np.full_like(v, 1.0 - BN_EPS)  # scale = 0 / sqrt(1)
            else:
                sd[k] = np.zeros_like(v)
    layout = _layout(model)
    extra = layout["dec_layers"]
    if layout["two_stage"]:
        # convert_state_dict clones all five heads for the extra set, as
        # the reference does: give it head 0's leaves there, then drop them
        sd = dict(sd, **{f"{name}.{extra}{k[len(name) + 2:]}": v
                         for name in UNCALLED_EXTRA_HEADS
                         for k, v in sd.items() if k.startswith(name + ".0.")})
    tree = convert_state_dict(sd, **layout)
    if layout["two_stage"]:
        for name in UNCALLED_EXTRA_HEADS:
            del tree["params"][f"{name}_{extra}"]
    if LEARNED_POSITION[0] in sd:  # convert_state_dict has no entry for these
        tree["params"]["position_embedding"] = {
            name: sd[key] for name, key in zip(("row_embed", "col_embed"), LEARNED_POSITION)}
    return tree


def get_checkpoint_state(model, optimizer, epoch, best_result, best_epoch):
    opt = optimizer.state_dict()
    opt_state = {"step": np.int32(opt["step"])}
    for key in ("m", "v"):
        if key in opt:
            opt_state[key] = to_jax_tree(model, opt[key])
    return {
        "epoch": epoch,
        "model_state": to_jax_tree(model),
        "optimizer_state": opt_state,
        "best_result": best_result,
        "best_epoch": best_epoch,
    }


def save_checkpoint(state, filename):
    with open("{}.pth".format(filename), "wb") as f:
        pickle.dump(state, f)


def load_checkpoint(filename, logger=None):
    """Unpickles: open only checkpoints this project wrote."""
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    if logger:
        logger.info("==> Loading from checkpoint '{}'".format(filename))
    with open(filename, "rb") as f:
        return pickle.load(f)


def load_model_state(model, tree):
    """Load a flax tree (full, from any checkpoint of either package) into
    the model, keeping its dtype and device."""
    ref = next(model.parameters())
    model.load_state_dict({k: v.to(ref.device, ref.dtype)
                           for k, v in params_from_jax(tree).items()})


def load_optimizer_state(optimizer, opt_state):
    values = {"step": int(opt_state["step"])}
    for key in ("m", "v"):
        if key in opt_state:
            values[key] = params_from_jax(opt_state[key])
    optimizer.load_state_dict(values)


def merge_params(base, update, path=""):
    """Merge a (possibly partial, e.g. backbone-only) parameter tree into
    `base`: every leaf of `update` replaces the same-named, same-shaped leaf
    of `base`.  Raises on unknown names and shape mismatches."""
    out = dict(base)
    for k, v in update.items():
        if k not in out:
            raise KeyError(f"checkpoint key not in model tree: {path}{k}")
        if isinstance(v, dict):
            out[k] = merge_params(out[k], v, path=f"{path}{k}/")
        else:
            if np.shape(out[k]) != np.shape(v):
                raise ValueError(f"shape mismatch at {path}{k}: model "
                                 f"{np.shape(out[k])} vs ckpt {np.shape(v)}")
            out[k] = v
    return out
