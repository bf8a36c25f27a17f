"""One training step of each query variant of monodetr_torch against
monodetr_tpu's make_train_step(donate=False), in f32 on the CPU at 64x128,
1 encoder and 2 decoder layers, dropout 0 (the depth encoder's 0.1, which
the JAX package applies whatever the config, is set to 0 on both sides),
on the weights of tests/test_torch_query_variants.py.

`use_dab` and `two_stage_dino` train at group_num 11 (550 and 110
queries), `two_stage` at group_num 1: its top-k takes num_queries
proposals in training too, which do not split into 11 groups; the port
refuses that with a ValueError where the JAX matcher fails to reshape.
Targets: 10 slots, 5 and 2 objects (DINO has 10 queries a group).
Tolerances: losses rtol 1e-5; gradients, read through AdamW's first moment
((1 - b1) g after one step), 1e-3 * max|g| + 1e-6 per tensor; updated
parameters 1e-3 absolute (one step moves a parameter by about lr = 2e-4).
Each variant also takes a bf16 autocast step and a bf16 eval forward on
the CPU, the dtype mix the card runs (no JAX there).
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
from monodetr_torch.train.optimizer import build_optimizer
from monodetr_torch.train.train_step import make_train_step
from tests.test_torch_criterion import make_targets
from tests.test_torch_query_variants import (VARIANTS, inputs, port_model, variant_cfg,
                                             variant_tree)

torch.set_num_threads(2)
OPT = {"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4}
LR = 2e-4


class _NoDropoutDepthEncoderLayer(jax_depth_predictor.DepthEncoderLayer):
    dropout: float = 0.0


def make_batch(seed=1):
    images, calibs, sizes = inputs(seed)
    batch = {"images": images, "calibs": calibs, "img_sizes": sizes}
    batch.update(make_targets(np.random.RandomState(seed), len(images), 10, (5, 2)))
    return batch


def jax_step(cfg, tree, batch):
    """(losses, new params, new AdamW state) of JAX's train step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_depth_predictor, "DepthEncoderLayer", _NoDropoutDepthEncoderLayer)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        opt_state, step_fn = jax_build_optimizer(OPT, params)
        step = jax_make_train_step(jax_build(dict(cfg, msda_impl="gather")), JaxCriterion(cfg),
                                   step_fn, donate=False)
        new_params, new_state, losses = step(
            params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(LR),
            jax.random.PRNGKey(0))
        return losses.as_dict(), new_params, new_state


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_matches_jax(variant):
    cfg = variant_cfg(variant)
    tree = variant_tree(cfg)
    batch = make_batch()
    want_losses, want_params, want_state = jax_step(cfg, tree, batch)

    model = port_model(cfg, tree)
    layer = model.depth_predictor.depth_encoder.layers[0]
    layer.dropout = layer.self_attn.dropout = 0.0
    opt = build_optimizer(OPT, model)
    got = make_train_step(model, SetCriterion(cfg), opt)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, LR).as_dict()

    assert list(got) == list(want_losses)
    for k in got:
        np.testing.assert_allclose(got[k], want_losses[k], rtol=1e-5, atol=1e-7, err_msg=k)
    m_want = params_from_jax(want_state.m)
    p_want = params_from_jax(want_params)
    state = model.state_dict()
    assert len(opt.names) > 100 and set(opt.names) <= set(m_want)
    for name, m in zip(opt.names, opt.m):
        want = m_want[name].numpy()
        tol = 1e-3 * np.abs(want).max() + 1e-6
        np.testing.assert_allclose(m.numpy(), want, rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(state[name].numpy(), p_want[name].numpy(), rtol=0,
                                   atol=1e-3, err_msg=name)
    # the variant's own tables are trained
    table = {"two_stage": "depthaware_transformer.pos_trans.weight",
             "use_dab": "refpoint_embed.weight",
             "two_stage_dino": "depthaware_transformer.tgt_embed.weight"}[variant]
    assert np.abs(m_want[table].numpy()).max() > 0


def test_two_stage_refuses_grouped_training():
    """two_stage takes num_queries proposals in training as in eval; at
    group_num 11 they do not split into groups (the JAX matcher fails at
    its reshape, monodetr_tpu/models/matcher.py:215-218)."""
    cfg = dict(variant_cfg("two_stage"), group_num=11)
    model = build_monodetr(cfg, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    step = make_train_step(model, SetCriterion(cfg), build_optimizer(OPT, model))
    with pytest.raises(ValueError, match="two_stage.*group_num: 1"):
        step(batch, LR)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_step_and_eval_run(variant):
    """The compute dtype of the card's path, on the CPU: a train step under
    bf16 autocast with f32 parameters and dropout, and the eval forward of
    the model cast to bf16.  The proposal branches and DAB's references stay
    f32 inside (autocast off), the heads run in bf16; both must meet
    without a dtype error, with finite losses and outputs."""
    cfg = dict(variant_cfg(variant), dropout=0.1)
    model = build_monodetr(cfg, seed=0)
    step = make_train_step(model, SetCriterion(cfg), build_optimizer(OPT, model), torch.bfloat16)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(2).items()}
    losses = step(batch, LR, torch.Generator().manual_seed(0)).as_dict()
    assert np.isfinite(list(losses.values())).all()
    model = build_monodetr(cfg, seed=0).to(torch.bfloat16)
    with torch.no_grad():
        out = model(batch["images"], batch["calibs"], batch["img_sizes"])
    assert out["pred_boxes"].dtype == torch.float32 and torch.isfinite(out["pred_boxes"]).all()
    if variant == "two_stage":
        assert out["enc_outputs"]["pred_logits"].dtype == torch.float32
