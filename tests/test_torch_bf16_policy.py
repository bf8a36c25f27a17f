"""The port's bf16 program is the JAX package's on every device.

CUDA autocast runs the ops of its f32 lists (AT_FORALL_FP32 and
AT_FORALL_FP32_SET_OPT_DTYPE in ATen/autocast_mode.h) in f32 and returns
f32: layer_norm and group_norm among them, where flax's LayerNorm and
GroupNorm return their `dtype`.  CPU autocast has no such rule, so a CPU
run under autocast does not see the program that the card runs.
`CudaAutocastRule` emulates CUDA's rule on the CPU: a TorchFunctionMode
that, while autocast is on, runs each op of those lists that meets a bf16
tensor on f32 copies of its tensors, with autocast off, and so returns f32.
It records the ops it met; those the model's forward reaches are REACHED.

- dtype map: under the emulation, a 1+1-layer model at 64x128 with f32
  parameters under bf16 autocast (as training, the tester and -e run it):
  every LayerNorm and GroupNorm output and every encoder, decoder and
  depth-encoder layer output has the dtype that MonoDETR.apply at `dtype:
  bf16` gives the same module (flax capture_intermediates, traced by
  jax.eval_shape on the same weights: the port's seeded init through
  train/checkpoint.py:to_jax_tree, loaded back through params_from_jax).
  The modules are paired through params_from_jax itself.  Over the default
  impls, A, B, the stress configuration's model options and the three
  query variants.
- device independence: the bf16 eval outputs with and without the
  emulation agree, max |a - b| <= 1e-2 max |b| per output (bf16 keeps 8
  bits; the runs differ by where the f32-list ops round); the proposal
  variants' second run takes the first run's proposal picks.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_leaves, tree_map

import jax
from flax.traverse_util import flatten_dict, unflatten_dict

from monodetr_tpu.models import build_monodetr as jax_build
from monodetr_torch.convert import params_from_jax
from monodetr_torch.models.layers import policy_modules, recorded_output_dtypes
from monodetr_torch.models.monodetr import build_monodetr
from monodetr_torch.train.checkpoint import load_model_state, to_jax_tree

torch.set_num_threads(2)
IMG_H, IMG_W, B = 64, 128, 2
BASE = dict(msda_window=6, dtype="bf16", enc_layers=1, dec_layers=1, dropout=0.0)
CONFIGS = {
    "default": dict(msda_impl="fused", dec_msda_impl="sep"),
    "A": dict(msda_impl="pallas", dec_msda_impl="dense_fused"),
    "B": dict(msda_impl="sepwin", dec_msda_impl="sep"),
    "stress": dict(msda_impl="fused", dec_msda_impl="sep", backbone="resnet101", dilation=True,
                   position_embedding="learned", remat=True),
    "two_stage": dict(msda_impl="fused", dec_msda_impl="sep", two_stage=True, group_num=1),
    "use_dab": dict(msda_impl="fused", dec_msda_impl="sep", use_dab=True),
    # 170 tokens at 64x128: 10 proposals
    "two_stage_dino": dict(msda_impl="fused", dec_msda_impl="sep", two_stage_dino=True,
                           num_queries=10),
}
# the JAX impl of each port impl on the CPU (tests/test_torch_model.py)
JAX_IMPL = {"fused": "windowed", "pallas": "windowed", "sepwin": "windowed",
            "sep": "sep", "dense_fused": "dense"}
OUT_KEYS = ("pred_logits", "pred_boxes", "pred_3d_dim", "pred_depth", "pred_angle",
            "pred_depth_map_logits", "weighted_depth")

# the Python names of the ops of CUDA autocast's f32 lists
FP32_OPS = frozenset((
    "acos", "asin", "cosh", "erfinv", "exp", "expm1", "log", "log10", "log2", "log1p",
    "reciprocal", "rsqrt", "sinh", "tan", "pow", "__pow__", "__rpow__", "softplus",
    "layer_norm", "rms_norm", "group_norm", "norm", "nuclear_norm", "cosine_similarity",
    "poisson_nll_loss", "cosine_embedding_loss", "nll_loss", "hinge_embedding_loss", "kl_div",
    "l1_loss", "smooth_l1_loss", "huber_loss", "mse_loss", "margin_ranking_loss",
    "multilabel_margin_loss", "soft_margin_loss", "triplet_margin_loss", "multi_margin_loss",
    "binary_cross_entropy_with_logits", "dist", "pdist", "cdist", "renorm", "logsumexp",
    "interpolate", "upsample", "upsample_nearest", "upsample_bilinear",
    # AT_FORALL_FP32_SET_OPT_DTYPE, when no dtype is given
    "prod", "softmax", "log_softmax", "cumprod", "cumsum", "vector_norm", "matrix_norm", "sum"))
# the ones that the eval forward meets with a bf16 tensor: F.interpolate in
# the depth predictor and the softmax of the plain attention's bf16 logits
# (layer_norm and group_norm took bf16 before the norms cast to f32 first)
REACHED = frozenset(("interpolate", "softmax"))


def is_bf16(x):
    return isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16


class CudaAutocastRule(TorchFunctionMode):
    """CUDA autocast's f32 rule on the CPU (module docstring); `reached`
    collects the names of the ops it ran in f32."""

    def __init__(self):
        super().__init__()
        self.reached = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if (name in FP32_OPS and torch.is_autocast_enabled("cpu")
                and kwargs.get("dtype") is None
                and any(is_bf16(x) for x in tree_leaves((args, kwargs)))):
            self.reached.add(name)
            args, kwargs = tree_map(lambda x: x.float() if is_bf16(x) else x, (args, kwargs))
            with torch.autocast("cpu", enabled=False):
                return func(*args, **kwargs)
        return func(*args, **kwargs)


def inputs(seed=1):
    rng = np.random.RandomState(seed)
    images = rng.randn(B, IMG_H, IMG_W, 3).astype(np.float32)
    calibs = np.tile(np.array([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                              np.float32), (B, 1, 1))
    calibs[-1, 0, 0] = 650.0
    sizes = np.tile(np.array([[1242.0, 375.0]], np.float32), (B, 1))
    return images, calibs, sizes


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    """(name, cfg, port model with f32 parameters, its JAX tree)."""
    cfg = dict(BASE, **CONFIGS[request.param])
    rng = np.random.RandomState(0)
    seeded = build_monodetr(cfg, seed=0)
    with torch.no_grad():  # samples that move off the init ring
        for name, p in seeded.named_parameters():
            if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.03))
    tree = to_jax_tree(seeded)
    model = build_monodetr(cfg)
    load_model_state(model, tree)
    return request.param, cfg, model, tree


def port_forward(model, emulate, proposal_idx=None):
    """The eval forward under bf16 autocast (with gradients on, the remat
    regions run as in training); with `emulate`, under CudaAutocastRule.
    Returns (outputs, {module: dtypes}, the ops emulated)."""
    rule = CudaAutocastRule()
    args = [torch.from_numpy(a) for a in inputs()]
    with recorded_output_dtypes(model) as seen, torch.autocast("cpu", dtype=torch.bfloat16):
        with rule if emulate else contextlib.nullcontext():
            out = model(*args, proposal_idx=proposal_idx)
    return out, seen, rule.reached


def jax_output_dtypes(cfg, tree):
    """{flax module path: dtype of its output} of MonoDETR.apply at `dtype:
    bf16`, by jax.eval_shape (nothing runs)."""
    jm = jax_build(dict(cfg, msda_impl=JAX_IMPL[cfg["msda_impl"]],
                        dec_msda_impl=JAX_IMPL[cfg["dec_msda_impl"]]))

    def run(params):
        _, state = jm.apply({"params": params}, *inputs(), train=False,
                            capture_intermediates=True, mutable=["intermediates"])
        return state["intermediates"]

    flat = flatten_dict(jax.eval_shape(run, tree["params"]), sep="/")
    return {k[:-len("/__call__")]: v[0].dtype for k, v in flat.items()
            if k.endswith("/__call__") and hasattr(v[0], "dtype")}


def flax_paths(tree):
    """{port module name: flax module path} of every module with a
    `weight` that params_from_jax fills from a flax `scale` (the norms),
    and of each layer with a `norm1`: params_from_jax run on a tree whose
    leaves hold their own index."""
    leaves = flatten_dict(tree["params"], sep="/")
    names = list(leaves)
    indexed = {k: np.full(np.shape(v), i, np.float32) for i, (k, v) in enumerate(leaves.items())}
    sd = params_from_jax(unflatten_dict(indexed, sep="/"))
    paths = {}
    for key, t in sd.items():
        if key.endswith(".weight") and t.ndim == 1:
            leaf = names[int(t.reshape(-1)[0])]
            if leaf.endswith("/scale"):
                paths[key[:-len(".weight")]] = leaf[:-len("/scale")]
    for name, path in list(paths.items()):
        if name.endswith(".norm1"):
            paths[name[:-len(".norm1")]] = path[:-len("/norm1")]
    return paths


def test_bf16_dtype_map_is_the_jax_models_under_cuda_autocast_rule(case):
    name, cfg, model, tree = case
    _, seen, reached = port_forward(model, emulate=True)
    want = jax_output_dtypes(cfg, tree)
    paths = flax_paths(tree)
    # every module that the policy fixes ran (but the proposal branches' f32
    # norms, which run through transformer.layer_norm_f32), each with a
    # flax counterpart that the trace captured
    f32_norms = ("enc_output_norm", "pos_trans_norm")
    assert set(seen) == {n for n in policy_modules(model) if not n.endswith(f32_norms)}
    assert all(paths.get(n) in want for n in seen), [n for n in seen if paths.get(n) not in want]
    got = {n: sorted(str(d).replace("torch.", "") for d in seen[n]) for n in sorted(seen)}
    expect = {n: [str(want[paths[n]])] for n in sorted(seen)}
    wrong = {n: (got[n], expect[n]) for n in got if got[n] != expect[n]}
    assert not wrong, f"{name}: {len(wrong)} of {len(got)} modules differ from JAX: {wrong}"
    # the norms and layers of each part of the model are among those held
    for part in ("input_proj.0.1", "depth_predictor.depth_head.4",
                 "depth_predictor.depth_encoder.layers.0",
                 "depthaware_transformer.encoder.layers.0.norm2",
                 "depthaware_transformer.encoder.layers.0",
                 "depthaware_transformer.decoder.layers.0.norm_depth",
                 "depthaware_transformer.decoder.layers.0"):
        assert got[part] == ["bfloat16"], (name, part, got.get(part))
    assert reached <= REACHED, f"{name}: f32-list ops met with bf16 not in REACHED: {reached}"


def test_bf16_outputs_do_not_depend_on_the_devices_autocast_lists(case):
    name, cfg, model, tree = case
    with torch.no_grad():
        cuda_rule, _, _ = port_forward(model, emulate=True)
        cpu_rule, _, _ = port_forward(model, emulate=False,
                                      proposal_idx=cuda_rule.get("proposal_idx"))
    for k in OUT_KEYS:
        a, b = cuda_rule[k].float(), cpu_rule[k].float()
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), (name, k)
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err <= 1e-2, f"{name}: {k} max |a - b| / max |b| = {err:.2e}"
