"""monodetr_torch/bench.py (python bench_torch.py) against bench.py, on the CPU.

- bench_env() equals bench.py's bench_env() less `rng_impl` under the
  default environment, the stress configuration, configurations A and B
  and each BENCH_REMAT spelling.
- make_batch equals bench.py:92-120's arrays bit for bit, dtypes included
  (rebuilt here with its numpy and jax.numpy calls).
- count_flops (FlopCounterMode through the plain versions) of the port's
  f32 step is within 5% of XLA's cost_analysis()["flops"] of the JAX
  package's compiled make_train_step, bench.py's method, at
  tests/test_torch_train.py's size (B=2, 128x256, 2+2 layers, its weights,
  msda_impl 'gather' in both packages, dropout 0) on bench's batch.
- One f32 step without dropout on bench's batch (labels 0-1, a mask that
  is not a prefix), port against JAX: the losses at test_torch_train.py's
  tolerance (rtol 1e-4).
- main(["--device", "cpu"]) with a 1+1-layer model, 1 warm-up step and
  3 windows of 1 step prints one stdout line, bench.KEYS (bench.py's keys
  less vs_baseline) in their order, 3 positive runs; without a card and
  without --device cpu it raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
import monodetr_tpu.models.depth_predictor as jax_depth_predictor
from monodetr_tpu.models import build_monodetr as jax_build
from monodetr_tpu.models.criterion import SetCriterion as JaxCriterion
from monodetr_tpu.train import build_optimizer as jax_build_optimizer
from monodetr_tpu.train import make_train_step as jax_make_train_step
from monodetr_torch import bench
from monodetr_torch.models.criterion import SetCriterion
from monodetr_torch.models.monodetr import build_monodetr
from monodetr_torch.train.checkpoint import load_model_state
from monodetr_torch.train.optimizer import build_optimizer
from monodetr_torch.train.train_step import batch_to_device, make_train_step
from tests.test_torch_train import (B, CFG, IMG_H, IMG_W, LR, OPT,  # noqa: F401
                                    _NoDropoutDepthEncoderLayer, port_model, weights)

torch.set_num_threads(2)
ENV_NAMES = ("BENCH_BS", "BENCH_H", "BENCH_W", "BENCH_REMAT", "BENCH_BACKBONE", "BENCH_MSDA",
             "BENCH_WINDOW", "BENCH_DEC_MSDA", "BENCH_RNG")
ENVS = {
    "default": {},
    "stress": {"BENCH_BACKBONE": "resnet101", "BENCH_H": "768", "BENCH_W": "2560",
               "BENCH_BS": "2", "BENCH_REMAT": "1"},
    "A": {"BENCH_MSDA": "pallas", "BENCH_DEC_MSDA": "dense_fused"},
    "B": {"BENCH_MSDA": "sepwin"},
    "remat 0": {"BENCH_REMAT": "0"},
    "remat 1": {"BENCH_REMAT": "1"},
    "remat backbone": {"BENCH_REMAT": "backbone"},
}


def set_env(monkeypatch, env):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("name", list(ENVS))
def test_bench_env_is_bench_py_s(monkeypatch, name):
    set_env(monkeypatch, ENVS[name])
    want = jax_bench.bench_env()
    del want["rng_impl"]
    assert bench.bench_env() == want


def bench_py_batch(B, H, W):
    """bench.py:92-120, line for line."""
    T = 50
    rng = np.random.RandomState(0)
    batch = {
        "images": jnp.asarray(rng.randn(B, H, W, 3).astype(np.float32)),
        "calibs": jnp.tile(
            jnp.asarray(
                [[721.54, 0.0, 609.56, 44.86],
                 [0.0, 721.54, 172.85, 0.22],
                 [0.0, 0.0, 1.0, 0.003]], jnp.float32,
            )[None],
            (B, 1, 1),
        ),
        "img_sizes": jnp.tile(jnp.asarray([[1242.0, 375.0]], jnp.float32), (B, 1)),
        "labels": jnp.asarray(rng.randint(0, 2, (B, T)).astype(np.int32)),
        "boxes": jnp.asarray(
            np.concatenate(
                [rng.rand(B, T, 2) * 0.8 + 0.1, rng.rand(B, T, 2) * 0.15 + 0.02], -1
            ).astype(np.float32)
        ),
        "boxes_3d": jnp.asarray(
            np.concatenate(
                [rng.rand(B, T, 2), rng.rand(B, T, 4) * 0.1 + 0.02], -1
            ).astype(np.float32)
        ),
        "depth": jnp.asarray((rng.rand(B, T, 1) * 50 + 5).astype(np.float32)),
        "size_3d": jnp.asarray((rng.rand(B, T, 3) + 0.8).astype(np.float32)),
        "heading_bin": jnp.asarray(rng.randint(0, 12, (B, T, 1)).astype(np.int32)),
        "heading_res": jnp.asarray((rng.randn(B, T, 1) * 0.2).astype(np.float32)),
        "mask": jnp.asarray(rng.rand(B, T) > 0.7),
    }
    return batch


@pytest.mark.parametrize("shape", [(2, 64, 128), (16, 24, 80)])
def test_make_batch_is_bench_py_s(shape):
    got, want = bench.make_batch(*shape), bench_py_batch(*shape)
    assert list(got) == list(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    mask = got["mask"]
    assert (mask[:, 1:] & ~mask[:, :-1]).any()  # not a prefix
    assert set(np.unique(got["labels"])) == {0, 1}


@pytest.fixture(scope="module")
def jax_step(weights):
    """JAX's make_train_step (msda_impl 'gather', the depth encoder's
    dropout at 0) on test_torch_train.py's weights and bench's batch at its
    size: (losses dict, XLA's FLOPs of the compiled step)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_depth_predictor, "DepthEncoderLayer", _NoDropoutDepthEncoderLayer)
        model = jax_build(dict(CFG, msda_impl="gather"))
        params = jax.tree_util.tree_map(jnp.asarray, weights)
        opt_state, step_fn = jax_build_optimizer(OPT, params)
        step = jax_make_train_step(model, JaxCriterion(CFG), step_fn, donate=False)
        batch = {k: jnp.asarray(v) for k, v in bench.make_batch(B, IMG_H, IMG_W).items()}
        args = (params, opt_state, batch, jnp.float32(LR), jax.random.PRNGKey(0))
        compiled = step.jitted.lower(*args).compile()
        flops = float(compiled.cost_analysis()["flops"])
        _, _, losses = step(*args)
        return losses.as_dict(), flops


def test_count_flops_is_within_5_percent_of_xla(weights, jax_step):
    _, xla_flops = jax_step
    model = build_monodetr(dict(CFG, msda_impl="gather"))
    load_model_state(model, weights)
    layer = model.depth_predictor.depth_encoder.layers[0]
    layer.dropout = layer.self_attn.dropout = 0.0
    step = make_train_step(model, SetCriterion(CFG), build_optimizer(OPT, model))
    batch = batch_to_device(bench.make_batch(B, IMG_H, IMG_W), "cpu")
    flops = bench.count_flops(model, step, batch)
    assert abs(flops / xla_flops - 1) < 0.05, (flops / 1e9, xla_flops / 1e9)
    assert not any(m.plain_ops for m in model.modules() if hasattr(m, "plain_ops"))


def test_step_on_bench_batch_matches_jax(weights, jax_step):
    want, _ = jax_step
    model = port_model(weights)
    step = make_train_step(model, SetCriterion(CFG), build_optimizer(OPT, model))
    got = step(batch_to_device(bench.make_batch(B, IMG_H, IMG_W), "cpu"), LR).as_dict()
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_main_prints_bench_py_s_line_on_the_cpu(monkeypatch, capsys):
    set_env(monkeypatch, {"BENCH_BS": "2", "BENCH_H": "64", "BENCH_W": "128"})
    monkeypatch.setattr(bench, "MONODETR_MODEL",
                        dict(bench.MONODETR_MODEL, enc_layers=1, dec_layers=1))
    monkeypatch.setattr(bench, "WARMUP_STEPS", 1)
    monkeypatch.setattr(bench, "WINDOW_STEPS", 1)
    bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert list(line) == list(bench.KEYS) and "vs_baseline" not in line
    assert line["metric"] == "train_throughput_64x128_bs2" and line["unit"] == "img/s/chip"
    assert len(line["runs"]) == 3 and all(r > 0 for r in line["runs"])
    assert line["value"] == round(float(np.median(line["runs"])), 2)
    assert line["flops_per_img"] > 0 and line["mfu"] >= 0


def test_main_without_a_card_raises(monkeypatch):
    set_env(monkeypatch, {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
