"""Rematerialisation in monodetr_torch (the config's `remat`), in f32 on the CPU.

- The port's train step (forward with train=True, matching, the losses,
  backward, the reference AdamW) with remat 'backbone', 'encoder' and True,
  dropout 0.1 drawn from one seeded generator, against the same step
  without remat: the same losses, every gradient, the updated parameters
  and the generator's final state.  The recompute runs the same ops on the
  same numbers, so the losses and the generator are bit-equal; a gradient
  may be summed in another order where two paths meet (the encoder layer's
  input feeds both checkpointed regions): within 1e-6 of its largest
  entry.
- The port's step with remat True and dropout 0 against the JAX package's
  make_train_step with remat True (its nn.remat scopes and the
  "msda_sampled" policy) on the same weights and batch, 1 + 1 layers at
  64x128: losses rtol 1e-4, gradients (through AdamW's first moment)
  1e-3 * max|g| + 1e-6, as tests/test_torch_train.py holds the step
  without remat.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import monodetr_tpu.models.depth_predictor as jax_depth_predictor
from monodetr_tpu.models import build_monodetr as jax_build
from monodetr_tpu.models.criterion import SetCriterion as JaxCriterion
from monodetr_tpu.train import build_optimizer as jax_build_optimizer
from monodetr_tpu.train import make_train_step as jax_make_train_step
from monodetr_torch.convert import params_from_jax
from monodetr_torch.models.criterion import SetCriterion
from monodetr_torch.models.monodetr import build_monodetr
from monodetr_torch.train.checkpoint import to_jax_tree
from monodetr_torch.train.optimizer import build_optimizer
from monodetr_torch.train.train_step import make_train_step
from tests.test_torch_criterion import make_targets

torch.set_num_threads(2)
OPT = {"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4}
LR = 2e-4
CFG = dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep", dtype="float32",
           enc_layers=2, dec_layers=2, dropout=0.1)


def make_batch(B, h, w, seed=1):
    rng = np.random.RandomState(seed)
    batch = {
        "images": rng.randn(B, h, w, 3).astype(np.float32),
        "calibs": np.tile(np.array([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                                   np.float32), (B, 1, 1)),
        "img_sizes": np.tile(np.array([[1242.0, 375.0]], np.float32), (B, 1)),
    }
    batch.update(make_targets(rng, B, 50, (5, 2)[:B]))
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def seeded_model(cfg):
    """The port's seeded init with random FrozenBN statistics and the
    encoder's sampling offsets at odd multiples of 1/32 px inside the
    window (tests/test_torch_train.py's weights: 'fused' is then the JAX
    'gather' function, off integer positions)."""
    rng = np.random.RandomState(0)
    model = build_monodetr(cfg, seed=0)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            enc = ".encoder." in name
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32) + 0.5))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1))
            elif name.endswith("sampling_offsets.weight"):
                t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32)
                                         * (0.0 if enc else 0.03)))
            elif name.endswith("sampling_offsets.bias") and enc:
                u = (rng.rand(*t.shape) * 2 - 1) * 1.9
                t.copy_(torch.from_numpy(((np.floor(u * 16) * 2 + 1) / 32).astype(np.float32)))
            elif name.endswith("attention_weights.weight"):
                t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.05))
    return model


def port_step(remat, batch):
    """(losses, {name: grad}, {name: updated parameter}, generator state)
    of one port train step from one seeded generator."""
    model = seeded_model(dict(CFG, remat=remat))
    opt = build_optimizer(OPT, model)
    gen = torch.Generator().manual_seed(7)
    losses = make_train_step(model, SetCriterion(CFG), opt)(batch, LR, gen)
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses.values, grads, params, gen.get_state()


@pytest.fixture(scope="module")
def plain_step():
    batch = make_batch(2, 64, 128)
    return batch, port_step(False, batch)


@pytest.mark.parametrize("remat", ["backbone", "encoder", True])
def test_remat_step_equals_the_step_without(plain_step, remat):
    batch, (want_losses, want_grads, want_params, want_gen) = plain_step
    losses, grads, params, gen_state = port_step(remat, batch)
    assert torch.equal(losses, want_losses)
    assert torch.equal(gen_state, want_gen)  # the decoder's draws follow unchanged
    assert grads.keys() == want_grads.keys() and len(grads) > 100
    for n, g in want_grads.items():
        assert (grads[n] - g).abs().max() <= 1e-6 * g.abs().max(), n
    for n, p in want_params.items():
        assert (params[n] - p).abs().max() <= 1e-6 * (p.abs().max() + 1), n


def test_remat_is_inactive_without_gradients(plain_step):
    """Evaluation (no autograd) runs no checkpoint: the same outputs."""
    batch, _ = plain_step
    a, b = seeded_model(dict(CFG, remat=False)), seeded_model(dict(CFG, remat=True))
    with torch.no_grad():
        x = [batch[k] for k in ("images", "calibs", "img_sizes")]
        for k, v in a(*x).items():
            if k != "aux_outputs":
                assert torch.equal(b(*x)[k], v), k


class _NoDropoutDepthEncoderLayer(jax_depth_predictor.DepthEncoderLayer):
    dropout: float = 0.0


def test_remat_step_matches_jax():
    cfg = dict(CFG, enc_layers=1, dec_layers=1, dropout=0.0, remat=True)
    model = seeded_model(cfg)
    layer = model.depth_predictor.depth_encoder.layers[0]
    layer.dropout = layer.self_attn.dropout = 0.0
    tree = to_jax_tree(model)
    batch = make_batch(1, 64, 128, seed=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_depth_predictor, "DepthEncoderLayer", _NoDropoutDepthEncoderLayer)
        jm = jax_build(dict(cfg, msda_impl="gather"))
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        opt_state, step_fn = jax_build_optimizer(OPT, params)
        step = jax_make_train_step(jm, JaxCriterion(cfg), step_fn, donate=False)
        _, want_state, want_losses = step(
            params, opt_state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
            jnp.float32(LR), jax.random.PRNGKey(0))
    want_losses = want_losses.as_dict()
    opt = build_optimizer(OPT, model)
    got = make_train_step(model, SetCriterion(cfg), opt)(batch, LR).as_dict()
    assert list(got) == list(want_losses)
    for k in got:
        np.testing.assert_allclose(got[k], want_losses[k], rtol=1e-4, atol=1e-6, err_msg=k)
    m_want = params_from_jax(want_state.m)
    for name, m in zip(opt.names, opt.m):
        want = m_want[name].numpy()
        np.testing.assert_allclose(m.numpy(), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max() + 1e-6, err_msg=name)
