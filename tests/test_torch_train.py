"""monodetr_torch training against monodetr_tpu.train, in f32 on the CPU.

- The reference AdamW over 3 steps against ref_adamw, with the name masks:
  in_proj_bias decays, biases do not, the stem and layer1 never move.
- The LR table against lr_at_epoch.
- The whole train step (forward with train=True, matching, the 8 losses
  with aux layers, backward, reference AdamW) at 128x256, B=2, 2+2 layers,
  dropout 0, against make_train_step(donate=False) on the same weights and
  batch.  JAX runs msda_impl 'gather' (exact sampling, cheaper to compile
  than 'windowed'); the encoder's offsets stay inside the window, where
  'fused' is the same function.  The
  depth encoder's dropout (0.1 whatever the config, as in the JAX package)
  is set to 0 on both sides.  Tolerances: losses rtol 1e-4; gradients
  (compared through AdamW's first moment, (1 - b1) * g after one step)
  1e-3 * max|g| + 1e-6 per tensor; updated parameters 1e-3 absolute (one
  step moves a parameter by about lr = 2e-4).
- A checkpoint round trip: the JAX MonoDETR.apply on the saved
  model_state matches the port's forward; resume restores step, m and v
  exactly.
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
from monodetr_tpu.train import lr_at_epoch as jax_lr_at_epoch
from monodetr_tpu.train import make_train_step as jax_make_train_step
from monodetr_tpu.train.optimizer import ref_adamw
from monodetr_torch.convert import params_from_jax
from monodetr_torch.models.criterion import SetCriterion
from monodetr_torch.models.monodetr import build_monodetr
from monodetr_torch.train.checkpoint import (get_checkpoint_state, load_checkpoint,
                                             load_model_state, load_optimizer_state,
                                             save_checkpoint, to_jax_tree)
from monodetr_torch.train.optimizer import RefAdamW, build_optimizer, is_frozen, wants_decay
from monodetr_torch.train.scheduler import lr_at_epoch
from monodetr_torch.train.train_step import make_train_step
from tests.test_torch_criterion import make_targets

torch.set_num_threads(2)
B, IMG_H, IMG_W = 2, 128, 256
CFG = dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep", dtype="float32",
           enc_layers=2, dec_layers=2, dropout=0.0)
OPT = {"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4}
LR = 2e-4


class _NoDropoutDepthEncoderLayer(jax_depth_predictor.DepthEncoderLayer):
    dropout: float = 0.0


def make_batch(seed=1):
    rng = np.random.RandomState(seed)
    batch = {
        "images": rng.randn(B, IMG_H, IMG_W, 3).astype(np.float32),
        "calibs": np.tile(np.array([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                                   np.float32), (B, 1, 1)),
        "img_sizes": np.tile(np.array([[1242.0, 375.0]], np.float32), (B, 1)),
    }
    batch.update(make_targets(rng, B, 50, (5, 2)))
    return batch


def port_model(tree):
    model = build_monodetr(CFG)
    load_model_state(model, tree)
    layer = model.depth_predictor.depth_encoder.layers[0]
    layer.dropout = layer.self_attn.dropout = 0.0
    return model


@pytest.fixture(scope="module")
def weights():
    """A flax tree from the port's seeded init with random FrozenBN
    statistics and attention-weight kernels.  The decoder's sampling-offset
    kernels are random; the encoder's are zero with biases at odd multiples
    of 1/32 px inside the window (|offset| <= 1.91 < lim = 1.99): with grid
    centres at multiples of 1/16 px, every encoder sample then sits >= 1/32
    px from an integer position, where the one-sided bilinear derivatives
    of the two packages' sampling could differ (ROADMAP.md C3).  The offset
    gradients are still exercised."""
    rng = np.random.RandomState(0)
    model = build_monodetr(CFG, seed=0)

    def rand(shape, scale):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)

    with torch.no_grad():
        for name, t in model.state_dict().items():
            enc = ".encoder." in name
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32) + 0.5))
            elif name.endswith("running_mean"):
                t.copy_(rand(t.shape, 0.1))
            elif name.endswith("sampling_offsets.weight"):
                t.copy_(rand(t.shape, 0.0 if enc else 0.03))
            elif name.endswith("sampling_offsets.bias") and enc:
                u = (rng.rand(*t.shape) * 2 - 1) * 1.9
                t.copy_(torch.from_numpy(((np.floor(u * 16) * 2 + 1) / 32).astype(np.float32)))
            elif name.endswith("attention_weights.weight"):
                t.copy_(rand(t.shape, 0.05))
    return to_jax_tree(model)


@pytest.fixture(scope="module")
def jax_train_step(weights):
    """JAX's train_step(params tree, batch) -> (losses dict, new params,
    new opt state), compiled once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_depth_predictor, "DepthEncoderLayer", _NoDropoutDepthEncoderLayer)
        model = jax_build(dict(CFG, msda_impl="gather"))
        _, step_fn = jax_build_optimizer(OPT, weights)
        step = jax_make_train_step(model, JaxCriterion(CFG), step_fn, donate=False)

        def run(tree, batch):
            params = jax.tree_util.tree_map(jnp.asarray, tree)
            opt_state, _ = jax_build_optimizer(OPT, params)
            new_params, new_state, losses = step(
                params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
                jnp.float32(LR), jax.random.PRNGKey(0))
            return losses.as_dict(), new_params, new_state

        run(weights, make_batch())  # trace with the depth encoder's dropout at 0
    return run


@pytest.fixture(scope="module")
def jax_step(weights, jax_train_step):
    return jax_train_step(weights, make_batch())


def test_train_step_matches_jax(weights, jax_step):
    want_losses, want_params, want_state = jax_step
    model = port_model(weights)
    opt = build_optimizer(OPT, model)
    step = make_train_step(model, SetCriterion(CFG), opt)
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    got = step(batch, LR).as_dict()

    assert list(got) == list(want_losses)
    for k in got:
        np.testing.assert_allclose(got[k], want_losses[k], rtol=1e-4, atol=1e-6, err_msg=k)
    m_want = params_from_jax(want_state.m)
    p_want = params_from_jax(want_params)
    state = model.state_dict()
    assert len(opt.names) > 100
    for name, m in zip(opt.names, opt.m):
        want = m_want[name].numpy()
        tol = 1e-3 * np.abs(want).max() + 1e-6
        np.testing.assert_allclose(m.numpy(), want, rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(state[name].numpy(), p_want[name].numpy(), rtol=0,
                                   atol=1e-3, err_msg=name)


def test_ref_adamw_matches_jax_with_name_masks():
    rng = np.random.RandomState(0)
    shapes = {"backbone.0.body.conv1.weight": (4, 3), "backbone.0.body.layer1.0.conv1.weight": (2,),
              "backbone.0.body.layer2.0.conv1.weight": (3, 2), "x.self_attn.in_proj_bias": (6,),
              "x.linear1.bias": (5,), "x.norm1.weight": (5,), "level_embed": (2, 3)}

    class Named(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for n, s in shapes.items():
                self.register_parameter(n.replace(".", "_"), torch.nn.Parameter(
                    torch.from_numpy(rng.randn(*s).astype(np.float32))))

        def named_parameters(self, *a, **k):
            return [(n, getattr(self, n.replace(".", "_"))) for n in shapes]

    model = Named()
    p0 = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    opt = RefAdamW(model.named_parameters(), 1e-4)
    assert opt.names == [n for n in shapes if not is_frozen(n)]
    assert wants_decay("x.self_attn.in_proj_bias") and not wants_decay("x.linear1.bias")
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()} for _ in range(3)]

    init, update = ref_adamw(1e-4)
    params = {n: jnp.asarray(v) for n, v in p0.items()}
    state = init(params)
    train_mask = {n: not is_frozen(n) for n in shapes}
    # the JAX rule: every leaf not named `bias` decays
    decay_mask = {n: n.rsplit(".", 1)[-1] != "bias" for n in shapes}
    for t, g in enumerate(grads):
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n])
        opt.step(1e-3)
        upd, state = update({n: jnp.asarray(v) for n, v in g.items()}, state, params, 1e-3,
                            train_mask, decay_mask)
        params = {n: params[n] + upd[n] for n in params}
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), rtol=1e-5,
                                   atol=1e-7, err_msg=n)
        if is_frozen(n):
            np.testing.assert_array_equal(p.detach().numpy(), p0[n])


def test_lr_schedule_matches_jax():
    cfgs = [{"decay_list": [125, 165], "decay_rate": 0.1, "warmup": False},
            {"decay_list": [125, 165], "decay_rate": 0.1, "warmup": True},
            {"type": "cos", "warmup": True}]
    for cfg in cfgs:
        for epoch in range(0, 196):
            assert lr_at_epoch(cfg, 2e-4, epoch) == jax_lr_at_epoch(cfg, 2e-4, epoch)


def test_checkpoint_round_trip_and_resume(weights, jax_train_step, tmp_path):
    """The JAX model (MonoDETR.apply inside its train step) runs the saved
    model_state to the port's outputs, as the losses on a new batch show;
    a resumed optimizer has the same step, m and v."""
    model = port_model(weights)
    opt = build_optimizer(OPT, model)
    step = make_train_step(model, SetCriterion(CFG), opt)
    batch = make_batch(3)
    for _ in range(2):
        step({k: torch.from_numpy(v) for k, v in batch.items()}, LR)
    save_checkpoint(get_checkpoint_state(model, opt, 2, 1.5, 1), str(tmp_path / "checkpoint"))
    state = load_checkpoint(str(tmp_path / "checkpoint.pth"))
    assert (state["epoch"], state["best_result"], state["best_epoch"]) == (2, 1.5, 1)
    with open(tmp_path / "checkpoint.pth", "rb") as f:
        assert b"torch" not in f.read()  # numpy leaves only

    want, _, _ = jax_train_step(state["model_state"], make_batch(4))
    fresh = port_model(weights)
    load_model_state(fresh, state["model_state"])
    got = make_train_step(fresh, SetCriterion(CFG), build_optimizer(OPT, fresh))(
        {k: torch.from_numpy(v) for k, v in make_batch(4).items()}, LR).as_dict()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)

    fresh = port_model(weights)
    opt2 = build_optimizer(OPT, fresh)
    load_model_state(fresh, state["model_state"])
    load_optimizer_state(opt2, state["optimizer_state"])
    assert opt2.step_count == opt.step_count == 2
    for a, b in zip(opt.m + opt.v, opt2.m + opt2.v):
        assert torch.equal(a, b)
    for name, p in fresh.named_parameters():
        assert torch.equal(p, dict(model.named_parameters())[name]), name


def test_ref_adamw_step_size_on_the_device_is_the_host_formula():
    """The step size lr * sqrt(1 - b2^t) / (1 - b1^t) that RefAdamW
    computes from its device tensors (the step counter and lr, both f32)
    equals, to 1 ulp, the f32 formula from the host's step count for steps
    1-1000, and again after load_state_dict sets the counter."""
    lr = 2e-4
    opt = RefAdamW([("w", torch.nn.Parameter(torch.zeros(3)))], 0.0)
    opt.lr.fill_(lr)

    def host(step):
        t = torch.tensor(float(step), dtype=torch.float32)
        return (torch.tensor(lr, dtype=torch.float32) * torch.sqrt(1 - opt.b2 ** t)
                / (1 - opt.b1 ** t))

    def ulps(a, b):
        return abs(int(a.view(torch.int32)) - int(b.view(torch.int32)))

    for step in range(1, 1001):
        opt.t.add_(1.0)
        assert ulps(opt.step_size(), host(step)) <= 1, step
    fresh = RefAdamW([("w", torch.nn.Parameter(torch.zeros(3)))], 0.0)
    fresh.lr.fill_(lr)
    fresh.load_state_dict(dict(opt.state_dict(), step=617))
    assert fresh.step_count == 617 and ulps(fresh.step_size(), host(617)) <= 1
