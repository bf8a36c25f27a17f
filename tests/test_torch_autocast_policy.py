"""The port's bf16 policy keeps f32 where the JAX package keeps f32, on the CPU.

- MSDeformAttn 'gather' (the encoder's msda_impl and the decoder's
  dec_msda_impl) computes its sampling-offset and attention-weight
  projections in f32 under torch.autocast, as the JAX module's proj_dtype
  does (monodetr_tpu/models/msda_module.py:157-165): the sampling
  locations and weights made from them are f32 and equal, bit for bit,
  those of the same module run in f32 without autocast.  'fused' keeps its
  offsets and logits in the compute dtype, as JAX does.
- tools/train_val_torch.py -e with `dtype: bf16` evaluates f32 parameters
  under autocast, as the JAX tester keeps its f32 params
  (tools/train_val.py:81-89): every parameter and floating buffer is f32
  after the checkpoint loads, and the result txts equal, byte for byte,
  those of the tester as the CLI runs it after training (f32 model,
  autocast) on the same checkpoint (a 1+1-layer model at 320x128, two
  synthetic KITTI images).
"""

import logging
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from monodetr_torch.data import build_dataloader
from monodetr_torch.eval import tester as tester_mod
from monodetr_torch.models.monodetr import build_monodetr
from monodetr_torch.train.checkpoint import get_checkpoint_state, save_checkpoint
from monodetr_torch.train.optimizer import build_optimizer
from tests.synthetic_kitti import make_synthetic_kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import train_val_torch  # noqa: E402

torch.set_num_threads(2)
SHAPES = ((8, 16), (4, 8), (2, 4), (1, 2))
S = sum(h * w for h, w in SHAPES)


def tiny_model(impl, seed=0):
    model = build_monodetr(dict(enc_layers=1, dec_layers=1, msda_impl=impl,
                                dec_msda_impl="gather" if impl == "gather" else "sep"), seed=seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():  # projections that move the samples off the init ring
        for name, p in model.named_parameters():
            if name.endswith(("sampling_offsets.weight", "attention_weights.weight")):
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.05))
    return model


def module_inputs(where, seed=1):
    """(query, reference points, value tokens) of the encoder's self
    attention (grid queries) or the decoder's cross attention (6-D boxes)."""
    rng = np.random.RandomState(seed)
    B, Q = 2, S if where == "encoder" else 10
    query = torch.from_numpy(rng.randn(B, Q, 256).astype(np.float32))
    value = torch.from_numpy(rng.randn(B, S, 256).astype(np.float32))
    if where == "encoder":
        from monodetr_torch.models.transformer import encoder_reference_points
        ref = encoder_reference_points(SHAPES)
        ref = torch.as_tensor(ref, dtype=torch.float32)[None, :, None, :].expand(B, S, 4, 2)
    else:
        box = np.concatenate([rng.rand(B, Q, 2) * 0.8 + 0.1, rng.rand(B, Q, 4) * 0.1 + 0.02], -1)
        ref = torch.from_numpy(box.astype(np.float32))[:, :, None].expand(B, Q, 4, 6)
    return query, ref, value


def attention_module(model, where):
    t = model.depthaware_transformer
    return t.encoder.layers[0].self_attn if where == "encoder" else t.decoder.layers[0].cross_attn


@pytest.mark.parametrize("where", ["encoder", "decoder"])
@pytest.mark.parametrize("query_dtype", [torch.float32, torch.bfloat16])
def test_gather_projections_are_f32_under_autocast(where, query_dtype):
    attn = attention_module(tiny_model("gather"), where)
    assert attn.impl == "gather"
    query, ref, value = module_inputs(where)
    with torch.no_grad():
        _, want = attn.sampling(query.to(query_dtype).float(), ref, value, SHAPES)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            _, got = attn.sampling(query.to(query_dtype), ref, value, SHAPES)
    for name, g, w in (("locations", got[2], want[2]), ("weights", got[3], want[3])):
        assert g.dtype == torch.float32, name
        assert torch.equal(g, w), name


def test_fused_projections_stay_in_the_compute_dtype():
    attn = attention_module(tiny_model("fused"), "encoder")
    query, ref, value = module_inputs("encoder")
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        _, args = attn.sampling(query, ref, value, SHAPES)
    offsets, logits = args[2], args[3]
    assert offsets.dtype == logits.dtype == torch.bfloat16


def read_txts(directory):
    txts = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            txts[name] = f.read()
    return txts


def test_evaluate_only_keeps_f32_parameters_and_equals_the_post_training_tester(
        tmp_path, monkeypatch):
    make_synthetic_kitti(str(tmp_path / "kitti"), n_train=1, n_val=2, seed=7)
    with open(os.path.join(REPO, "configs", "monodetr.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"].update(root_dir=str(tmp_path / "kitti"), batch_size=2, resolution=[320, 128])
    cfg["model"].update(enc_layers=1, dec_layers=1)
    assert cfg["model"]["dtype"] == "bf16"
    cfg["model_name"] = "evaluate_only"
    cfg["tester"].update(threshold=0.0, checkpoint_path=str(tmp_path / "ckpt.pth"))
    with open(tmp_path / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)

    # the checkpoint: a seeded model whose f32-by-design leaves carry more
    # than bf16's 8 bits (FrozenBN statistics, the reference-point linear)
    model = build_monodetr(cfg["model"], seed=5)
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32) + 0.5))
            elif name.endswith("running_mean") or "reference_points" in name:
                t.add_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1))
    save_checkpoint(get_checkpoint_state(model, build_optimizer(cfg["optimizer"], model), 1, 0, 1),
                    str(tmp_path / "ckpt"))

    seen = {}

    class Recording(tester_mod.Tester):
        def test(self):
            out = super().test()
            seen["dtypes"] = {t.dtype for t in list(self.model.parameters())
                              + list(self.model.buffers()) if t.is_floating_point()}
            seen["autocast"] = (torch.is_autocast_enabled("cpu"),
                                torch.get_autocast_dtype("cpu"))
            return out

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train_val_torch, "Tester", Recording)
    train_val_torch.main(["--config", "tiny.yaml", "-e", "--device", "cpu"])
    assert seen["dtypes"] == {torch.float32}
    assert seen["autocast"] == (True, torch.bfloat16)
    got = read_txts(tmp_path / "outputs" / "evaluate_only" / "outputs" / "data")

    # the tester as tools/train_val_torch.py runs it after training
    _, test_loader = build_dataloader(cfg["dataset"])
    tester = tester_mod.Tester(cfg["tester"], build_monodetr(cfg["model"], seed=444),
                               test_loader, logging.getLogger("post_training"), cfg["trainer"],
                               "post_training", device="cpu")
    with torch.autocast("cpu", dtype=torch.bfloat16):
        tester.test()
    want = read_txts(tmp_path / "outputs" / "post_training" / "outputs" / "data")
    assert len(want) == 2 and all(len(rows.splitlines()) == 50 for rows in want.values())
    assert got == want
