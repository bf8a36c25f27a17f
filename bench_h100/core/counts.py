"""The yardstick's arithmetic: the H100's published peaks, the floating
point operations of one image through the reference (FlopCounterMode on
the meta device, no recomputation), and the work of the encoder's
deformable-attention range, from which its roofline share is taken.

    python bench_h100/core/counts.py <config name>   # prints the frozen counts

The peaks are NVIDIA's data sheet for the H100 SXM at 700 W, dense rates.
"""

import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_h100.core import spec  # noqa: E402

BF16_TC_FLOPS = 989.4e12
F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
# least f32 operations per (query, head, sample, channel) of the bilinear
# sampling: forward 4 corner multiply-adds; backward those into the value
# gradient and the 4 dot products of the output gradient with the corners
SAMPLE_OPS = {"fwd": 8, "bwd": 16}


def flops_per_image(arch, model_cfg, height, width, train):
    """Matrix-product and convolution operations of one image through the
    model of the reference module `arch`: the training forward (all query
    groups) and its backward, or the eval forward."""
    model = arch.build(model_cfg, "meta")
    for n, p in model.named_parameters():
        p.requires_grad_(train and arch.trained(n))
    images = torch.empty(1, height, width, 3, device="meta")
    calibs = torch.empty(1, 3, 4, device="meta")
    sizes = torch.empty(1, 2, device="meta")
    with FlopCounterMode(display=False) as fc:
        outs, depth_logits, _ = model(images, calibs, sizes, train, None)
        if train:
            (sum(v.sum() for o in outs for v in o.values()) + depth_logits.sum()).backward()
    return int(fc.get_total_flops())


def level_shapes(height, width, levels=4):
    """The (h, w) of the strides 8, 16, 32 and 64 levels."""
    shapes, h, w = [], height, width
    for _ in range(2):  # stem and max pool
        h, w = (h + 1) // 2, (w + 1) // 2
    for _ in range(levels):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return shapes


def enc_msda_work(model_cfg, height, width):
    """Per image and encoder layer, the least work of the `encoder MSDA`
    range: the value, offset and weight projections of every token, the
    sampling, and the range's inputs (tokens, positions) and output read or
    written once in bf16.  {direction: {bf16_flops, f32_ops, bytes}}."""
    m = model_cfg
    S = sum(h * w for h, w in level_shapes(height, width, m["num_feature_levels"]))
    C, H = m["hidden_dim"], m["nheads"]
    LP = m["num_feature_levels"] * m["enc_n_points"]
    gemm = 2 * S * C * (C + 3 * H * LP)
    samples = S * H * LP * (C // H)
    return {
        "fwd": {"bf16_flops": gemm, "f32_ops": SAMPLE_OPS["fwd"] * samples,
                "bytes": 3 * S * C * 2},
        # the input and weight gradients of the projections; the output
        # gradient, tokens and positions read, the token gradient written
        "bwd": {"bf16_flops": 2 * gemm, "f32_ops": SAMPLE_OPS["bwd"] * samples,
                "bytes": 4 * S * C * 2},
    }


def least_ms(work, directions, images, layers):
    """The larger of the bytes over the memory rate and each type of
    operation over its peak, for `images` images through `layers` layers."""
    tot = {k: sum(work[d][k] for d in directions) * images * layers
           for k in ("bf16_flops", "f32_ops", "bytes")}
    return 1e3 * max(tot["bytes"] / HBM_BYTES_S, tot["bf16_flops"] / BF16_TC_FLOPS,
                     tot["f32_ops"] / F32_FLOPS)


def frozen_counts(config):
    """The counts that a configuration file keeps under `counts`."""
    m, (h, w) = config["model"], (config["input"]["height"], config["input"]["width"])
    arch = spec.reference(config)
    return {
        "train_flops_per_img": flops_per_image(arch, m, h, w, True),
        "eval_flops_per_img": flops_per_image(arch, m, h, w, False),
        "enc_msda_per_img_layer": enc_msda_work(m, h, w),
    }


if __name__ == "__main__":
    print(json.dumps(frozen_counts(spec.load_config(sys.argv[1])), indent=1))
