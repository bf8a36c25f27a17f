"""The port's checkpoint converter (monodetr_torch/convert.py:
convert_state_dict, convert_torchvision_backbone) and its command line
(tools/convert_checkpoint_torch.py) against tools/convert_checkpoint.py,
and what the port does with what they write.

- The two converters give equal trees (the same paths in the same order,
  each leaf np.array_equal with the same dtype) for ResNet-50 and
  ResNet-101 in each query layout, and for both torchvision backbones.
  The conversion reads names, not widths: the state dicts are
  tests/test_checkpoint_convert.py's, each array cut to at most 3 a side.
- Both command lines, on one torch.save'd .pth, write equal pickles and
  print the same line.
- A Trainer given `pretrain_model` from the port's backbone-only conversion
  of a full-width ResNet-50 state dict: conv weights bit-equal to the
  source, each FrozenBN's folded affine within 1e-6 of the source's, every
  other entry of the model's state unchanged from the init.
- A full conversion of a reference-layout state dict (the port model's,
  with the reference's dead sa_v_proj and label_enc), loaded into the port
  and into MonoDETR.apply: the same eval forward at f32 within
  tests/test_torch_model.py's whole-forward tolerance (1e-3), and the
  loaded port model's forward within it of the source model's.
"""

import functools
import logging
import os
import pickle
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, "tools")
import convert_checkpoint as jax_tool  # noqa: E402

from monodetr_tpu.models import build_monodetr as jax_build  # noqa: E402
from monodetr_torch import convert  # noqa: E402
from monodetr_torch.models.backbone import BN_EPS, FrozenBatchNorm2d  # noqa: E402
from monodetr_torch.models.criterion import SetCriterion  # noqa: E402
from monodetr_torch.models.monodetr import build_monodetr  # noqa: E402
from monodetr_torch.train.trainer import Trainer  # noqa: E402
from tests.test_checkpoint_convert import (  # noqa: E402
    synth_reference_state_dict, synth_torchvision_state_dict)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TOOL = os.path.join(REPO, "tools", "convert_checkpoint_torch.py")
JAX_TOOL = os.path.join(REPO, "tools", "convert_checkpoint.py")
LAYOUTS = {"default": {}, "two_stage": {"two_stage": True}, "use_dab": {"use_dab": True},
           "two_stage_dino": {"two_stage_dino": True}}
CFG = dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep", dtype="float32",
           enc_layers=1, dec_layers=1)
IMG_H, IMG_W = 128, 256


def cut(sd):
    """Each array cut to at most 3 along every axis (real values: running
    variances stay positive)."""
    return {k: np.array(v[tuple(slice(0, 3) for _ in np.shape(v))]) for k, v in sd.items()}


@functools.lru_cache(maxsize=None)
def standard_sd(backbone):
    """tests/test_checkpoint_convert.py's reference-layout state dict, cut."""
    return cut(synth_reference_state_dict(np.random.RandomState(0), backbone))


@functools.lru_cache(maxsize=None)
def torchvision_sd(backbone):
    """tests/test_checkpoint_convert.py's torchvision-layout state dict, cut."""
    return cut(synth_torchvision_state_dict(np.random.RandomState(5), backbone))


def reference_sd(backbone, layout):
    """standard_sd with the query layout's own layers (names as the
    reference has them)."""
    rng = np.random.RandomState(1)
    sd = dict(standard_sd(backbone))

    def lin(prefix):
        sd[prefix + ".weight"] = rng.randn(3, 2).astype(np.float32)
        sd[prefix + ".bias"] = rng.randn(3).astype(np.float32)

    def mlp(prefix, n):
        for i in range(n):
            lin(f"{prefix}.layers.{i}")

    tr = "depthaware_transformer."
    if layout in ("two_stage", "two_stage_dino"):
        lin(tr + "enc_output")
        lin(tr + "enc_output_norm")
    if layout == "two_stage":
        lin(tr + "pos_trans")
        lin(tr + "pos_trans_norm")
        lin("class_embed.3")
        for name, n in (("bbox_embed", 3), ("dim_embed_3d", 2), ("angle_embed", 2),
                        ("depth_embed", 2)):
            mlp(f"{name}.3", n)
    if layout in ("use_dab", "two_stage_dino"):
        mlp(tr + "decoder.ref_point_head", 2)
        mlp(tr + "decoder.query_scale", 2)
    if layout == "use_dab":
        sd["tgt_embed.weight"] = rng.randn(3, 3).astype(np.float32)
        sd["refpoint_embed.weight"] = rng.randn(3, 3).astype(np.float32)
    if layout == "two_stage_dino":
        sd[tr + "tgt_embed.weight"] = rng.randn(3, 3).astype(np.float32)
        lin(tr + "enc_out_class_embed")
        mlp(tr + "enc_out_bbox_embed", 3)
    return sd


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in flat(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def assert_equal_trees(got, want):
    got, want = flat(got), flat(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), k


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_convert_state_dict_equals_the_tools(backbone, layout):
    sd = reference_sd(backbone, layout)
    got = convert.convert_state_dict(sd, backbone=backbone, **LAYOUTS[layout])
    want = jax_tool.convert_state_dict(sd, backbone=backbone, **LAYOUTS[layout])
    assert_equal_trees(got, want)
    n_blocks = sum(1 for k in got["params"]["backbone"] if k.startswith("layer"))
    assert n_blocks == sum(convert.STAGE_BLOCKS[backbone])


@pytest.mark.parametrize("backbone", ["resnet50", "resnet101"])
def test_convert_torchvision_backbone_equals_the_tools(backbone):
    sd = torchvision_sd(backbone)
    got = convert.convert_torchvision_backbone(sd, backbone)
    assert list(got) == ["params"] and list(got["params"]) == ["backbone"]
    assert_equal_trees(got, jax_tool.convert_torchvision_backbone(sd, backbone))


def run_tool(path, argv, monkeypatch, capsys):
    """`python <path> argv` in this process; its printed line."""
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [path] + argv)
        runpy.run_path(path, run_name="__main__")
    return capsys.readouterr().out.strip()


@pytest.mark.parametrize("flags", [
    [], ["--two-stage"], ["--use-dab"], ["--two-stage-dino"],
    ["--torchvision-backbone", "resnet50"], ["--torchvision-backbone", "resnet101"]],
    ids=lambda f: " ".join(f) or "default")
def test_both_command_lines_write_the_same_checkpoint(flags, tmp_path, monkeypatch, capsys):
    if flags[:1] == ["--torchvision-backbone"]:
        src = {k: torch.from_numpy(v) for k, v in torchvision_sd(flags[1]).items()}
    else:
        layout = flags[0][2:].replace("-", "_") if flags else "default"
        src = {"model_state": {k: torch.from_numpy(v)
                               for k, v in reference_sd("resnet50", layout).items()},
               "epoch": 7, "best_result": 0.25, "best_epoch": 5}
    torch.save(src, tmp_path / "src.pth")
    lines, states = {}, {}
    for name, tool in (("port", PORT_TOOL), ("jax", JAX_TOOL)):
        out = str(tmp_path / name)
        lines[name] = run_tool(tool, [str(tmp_path / "src.pth"), out] + flags, monkeypatch,
                               capsys).replace(out, "OUT")
        with open(out + ".pth", "rb") as f:
            states[name] = pickle.load(f)
    assert lines["port"] == lines["jax"] and lines["port"].startswith("converted ")
    port, ref = states["port"], states["jax"]
    assert list(port) == list(ref)
    assert {k: v for k, v in port.items() if k != "model_state"} == \
        {k: v for k, v in ref.items() if k != "model_state"}
    if not flags:
        assert (port["epoch"], port["best_result"], port["best_epoch"]) == (7, 0.25, 5)
    assert_equal_trees(port["model_state"], ref["model_state"])


def folded(weight, bias, mean, var):
    scale = np.asarray(weight, np.float64) / np.sqrt(np.asarray(var, np.float64) + BN_EPS)
    return scale, np.asarray(bias, np.float64) - np.asarray(mean, np.float64) * scale


def test_trainer_starts_from_a_converted_imagenet_backbone(tmp_path):
    """The reference's ImageNet start through the port alone: a torchvision
    ResNet-50 state dict, converted by tools/convert_checkpoint_torch.py in
    a process of its own, merged by the Trainer into the model's init."""
    sd = synth_torchvision_state_dict(np.random.RandomState(7), "resnet50")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tmp_path / "r50.pth")
    proc = subprocess.run([sys.executable, PORT_TOOL, str(tmp_path / "r50.pth"),
                           str(tmp_path / "r50_pretrain"), "--torchvision-backbone", "resnet50"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    model = build_monodetr(CFG, seed=3)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    Trainer({"pretrain_model": str(tmp_path / "r50_pretrain.pth"), "max_epoch": 1}, model,
            SetCriterion(CFG), None, {}, {"type": "adamw", "lr": 2e-4},
            logging.getLogger("test_torch_convert"), "convert", device="cpu")
    state = model.state_dict()
    body = "backbone.0.body."
    bns = {n[len(body):] for n, m in model.backbone[0].body.named_modules(prefix=body[:-1])
           if isinstance(m, FrozenBatchNorm2d)}
    n_conv = 0
    for k, v in state.items():
        if not k.startswith(body):
            assert torch.equal(v, init[k]), k
        elif k.endswith(".weight") and k[len(body):-len(".weight")] not in bns:
            assert torch.equal(v, torch.from_numpy(sd[k[len(body):]])), k
            n_conv += 1
    assert n_conv == 1 + 3 * 16 + 4  # the stem, 3 per block, the 4 downsamples
    assert len(bns) == n_conv
    for bn in bns:
        got = folded(*(state[f"{body}{bn}.{p}"].numpy()
                       for p in ("weight", "bias", "running_mean", "running_var")))
        want = folded(*(sd[f"{bn}.{p}"] for p in ("weight", "bias", "running_mean",
                                                  "running_var")))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=bn)


def test_a_converted_reference_checkpoint_runs_as_the_jax_model():
    rng = np.random.RandomState(0)
    source = build_monodetr(CFG, seed=0)
    sd = {k: v.numpy().copy() for k, v in source.state_dict().items()}
    for k, v in sd.items():  # as tests/test_torch_model.py's weights
        if k.endswith("running_var") or (".bn" in k and k.endswith("weight")):
            sd[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        elif k.endswith("running_mean") or (".bn" in k and k.endswith("bias")):
            sd[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("sampling_offsets.weight"):
            sd[k] = (rng.randn(*v.shape) * 0.03).astype(np.float32)
        elif k.endswith("attention_weights.weight"):
            sd[k] = (rng.randn(*v.shape) * 0.05).astype(np.float32)
    source.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    # the reference's dead parameters, which the conversion skips
    sd["depthaware_transformer.decoder.layers.0.sa_v_proj.weight"] = rng.randn(256, 256)
    sd["depthaware_transformer.decoder.layers.0.sa_v_proj.bias"] = rng.randn(256)
    sd["label_enc.weight"] = rng.randn(4, 255).astype(np.float32)
    tree = convert.convert_state_dict(sd, enc_layers=1, dec_layers=1)
    assert_equal_trees(tree, jax_tool.convert_state_dict(sd, enc_layers=1, dec_layers=1))

    loaded = build_monodetr(CFG, seed=1)
    loaded.load_state_dict(convert.params_from_jax(tree))
    b = 1
    images = rng.randn(b, IMG_H, IMG_W, 3).astype(np.float32)
    calibs = np.array([[[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]]], np.float32)
    sizes = np.array([[1242.0, 375.0]], np.float32)
    jm = jax_build(dict(CFG, msda_impl="windowed"))
    want = jax.jit(lambda p: jm.apply({"params": p}, images, calibs, sizes, train=False))(
        tree["params"])
    with torch.no_grad():
        args = [torch.from_numpy(x) for x in (images, calibs, sizes)]
        got, src_out = loaded(*args), source(*args)
    for k in ("pred_logits", "pred_boxes", "pred_3d_dim", "pred_depth", "pred_angle",
              "pred_depth_map_logits", "weighted_depth"):
        assert np.isfinite(got[k].numpy()).all(), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-3, atol=1e-3,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), src_out[k].numpy(), rtol=1e-3, atol=1e-3,
                                   err_msg=k)
