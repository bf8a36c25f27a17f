"""Weights made from a seed on the card, in the layout of the published
checkpoint (the state dict of the configuration's reference module,
`arch`), which loads into the reference and into the program alike.

Every drawn leaf is a slice of one normal draw from a card generator,
scaled per leaf: matrix and convolution kernels by 1 / sqrt(fan in) (the
in-projections of attention and the level projections by
sqrt(2 / (fan in + fan out))), embeddings and level embeddings by 1 (those
of EMBEDDINGS and of the reference module's own EMBEDDINGS).
Biases are 0, norms the identity, frozen batch norm the identity.  Three
leaves follow MonoDETR's own initialisation: the sampling offsets' bias is
the ring of unit directions scaled by point index (shrunk to 0.75 of the
window's reach in the windowed encoder), the first box head's extent bias
is -2, and the class bias is set by `class_bias` so that a fixed number of
(query, class) scores of a frame pass the decode threshold, as a trained
model's detections do: the decode's work then does not change with the
seed.  The offset kernels are drawn like any kernel, so that samples fall
around the ring and some beyond the encoder's window, as a trained
model's do.
"""

import math

import numpy as np
import torch


def offset_ring(heads, levels, points, max_radius=None):
    thetas = np.arange(heads, dtype=np.float32) * (2.0 * math.pi / heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, levels, points, 1))
    grid = grid * np.arange(1, points + 1, dtype=np.float32)[None, None, :, None]
    if max_radius is not None:
        grid = grid * (max_radius / points)
    return grid.reshape(-1).astype(np.float32)


EMBEDDINGS = ("query_embed.weight", "depth_predictor.depth_pos_embed.weight",
              "depthaware_transformer.level_embed")


def _scale(name, shape, embeddings=EMBEDDINGS):
    """Standard deviation of a drawn leaf, None for a leaf that is set."""
    if name in embeddings:
        return 1.0
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("weight", "in_proj_weight") and len(shape) >= 2:
        fan_in = int(np.prod(shape[1:]))
        if leaf == "in_proj_weight" or name.startswith("input_proj."):
            return math.sqrt(2.0 / (fan_in + shape[0] * int(np.prod(shape[2:]))))
        return 1.0 / math.sqrt(fan_in)
    return None


def make_state(arch, seed, config, device):
    """{name: f32 tensor on `device`} for every entry of the state dict of
    the reference module `arch`'s model, drawn from `seed`; `config` gives
    the model's sizes.  The class bias is 0 (see class_bias)."""
    embeddings = EMBEDDINGS + getattr(arch, "EMBEDDINGS", ())
    spec = [(n, tuple(t.shape))
            for n, t in arch.build(config["model"], "meta").state_dict().items()]
    drawn = [(n, s, _scale(n, s, embeddings)) for n, s in spec]
    total = sum(int(np.prod(s)) for _, s, sd in drawn if sd is not None)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for n, s, sd in drawn:
        if sd is not None:
            k = int(np.prod(s))
            state[n] = flat[at:at + k].view(s) * sd
            at += k
        elif n.endswith("running_var") or n.endswith("weight"):
            state[n] = torch.ones(s, device=device)
        else:
            state[n] = torch.zeros(s, device=device)
    m = config["model"]
    H, L = m["nheads"], m["num_feature_levels"]
    for prefix, points, radius in (
            ("depthaware_transformer.encoder.layers", m["enc_n_points"],
             0.75 * (m["msda_window"] / 2 - 1)),
            ("depthaware_transformer.decoder.layers", m["dec_n_points"], None)):
        ring = torch.from_numpy(offset_ring(H, L, points, radius)).to(device)
        for n in state:
            if n.startswith(prefix) and n.endswith("sampling_offsets.bias"):
                state[n] = ring.clone()
    state["bbox_embed.0.layers.2.bias"] = torch.tensor([0.0, 0.0, -2.0, -2.0, -2.0, -2.0],
                                                        device=device)
    return state


def set_class_bias(state, bias):
    for n in state:
        if n.startswith("class_embed.") and n.endswith(".bias"):
            state[n] = torch.full_like(state[n], bias)
    return state


@torch.no_grad()
def class_bias(arch, config, state, images, calibs, img_sizes, device):
    """The class bias at which `rows_per_frame` of the last decoder layer's
    (query, class) scores of the eval forward of one frame (the reference,
    float32) reach the `threshold`; the other frames of a mix then
    decode about as many rows."""
    w = config["weights"]
    model = arch.build(config["model"], device)
    model.load_state_dict(set_class_bias(dict(state), 0.0))
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        outs = model(images, calibs, img_sizes)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    top = outs[-1]["pred_logits"][0].flatten().double().sort(descending=True).values
    k, t = w["rows_per_frame"], w["threshold"]
    return math.log(t / (1 - t)) - float(top[k - 1] + top[k]) / 2
