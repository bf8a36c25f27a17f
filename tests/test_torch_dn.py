"""monodetr_torch/models/dn.py against monodetr_tpu/models/dn.py on the CPU.

The JAX function draws its noise from jax.random keys; the port's
`dn_queries` takes the same three draws (label-flip uniforms, random
labels, box uniforms), made here by jax.random from the JAX function's
keys, so both build the same queries: every output at 1e-6.  The cases
of tests/test_dn.py run on the port: shapes, the noise bounds, the
attention mask's structure, the split of the decoder outputs and the zero
paths of the loss; `prepare_for_dn` draws from a torch.Generator."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monodetr_tpu.models import dn as jdn
from monodetr_torch.models import dn

B, T, S, C, HID = 2, 6, 3, 3, 32
TOL = dict(rtol=1e-6, atol=1e-6)


def make_targets(rng):
    """tests/test_dn.py's targets, as numpy."""
    mask = np.zeros((B, T), bool)
    mask[0, :4] = True
    mask[1, :2] = True
    return {
        "labels": rng.randint(0, 3, (B, T)).astype(np.int32),
        "boxes_3d": np.concatenate([rng.rand(B, T, 2), rng.rand(B, T, 4) * 0.2 + 0.02],
                                   -1).astype(np.float32),
        "size_3d": rng.rand(B, T, 3).astype(np.float32),
        "depth": rng.rand(B, T, 1).astype(np.float32) * 50,
        "heading_bin": rng.randint(0, 12, (B, T, 1)).astype(np.int32),
        "heading_res": rng.randn(B, T, 1).astype(np.float32) * 0.1,
        "mask": mask,
    }


def jax_draws(key, num_classes=C):
    """The draws of monodetr_tpu/models/dn.py:prepare_for_dn for `key`."""
    k1, k2, k3 = jax.random.split(key, 3)
    return (np.array(jax.random.uniform(k1, (B, S, T))),
            np.array(jax.random.randint(k2, (B, S, T), 0, num_classes)),
            np.array(jax.random.uniform(k3, (B, S, T, 6))))


def torch_targets(targets):
    return {k: torch.from_numpy(v) for k, v in targets.items()}


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", [0, 5])
def test_dn_queries_match_jax_on_its_draws(seed):
    rng = np.random.RandomState(seed)
    targets = make_targets(rng)
    table = rng.randn(C + 1, HID - 1).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jdn.prepare_for_dn(key, {k: jnp.asarray(v) for k, v in targets.items()},
                              jnp.asarray(table), scalar=S, num_classes=C)
    flip_u, rand_labels, box_u = (torch.from_numpy(x) for x in jax_draws(key))
    got = dn.dn_queries(torch_targets(targets), torch.from_numpy(table), flip_u, rand_labels,
                        box_u)
    for g, w in zip(got[:3], want[:3]):
        assert tuple(g.shape) == w.shape
        close(g, w)
    assert got[3].keys() == want[3].keys()
    for k, w in want[3].items():
        g = got[3][k]
        if isinstance(w, int):
            assert g == w, k
        else:
            close(g, w)


@pytest.mark.parametrize("pad,single,match", [(6, 2, 4), (18, 6, 0), (0, 6, 5)])
def test_dn_attn_mask_matches_jax(pad, single, match):
    np.testing.assert_array_equal(dn.dn_attn_mask(pad, single, match).numpy(),
                                  np.asarray(jdn.dn_attn_mask(pad, single, match)))


def decoder_outputs(rng, L, pad):
    return [rng.randn(L, B, pad, d).astype(np.float32) for d in (3, 6, 3, 2, 24)]


def test_post_process_and_dn_loss_match_jax():
    rng = np.random.RandomState(2)
    targets = make_targets(rng)
    table = rng.randn(C + 1, HID - 1).astype(np.float32)
    key = jax.random.PRNGKey(0)
    _, _, _, jmd = jdn.prepare_for_dn(key, {k: jnp.asarray(v) for k, v in targets.items()},
                                      jnp.asarray(table), scalar=S, num_classes=C)
    *_, md = dn.dn_queries(torch_targets(targets), torch.from_numpy(table),
                           *(torch.from_numpy(x) for x in jax_draws(key)))
    L, pad, Q = 3, S * T, S * T + 10
    arrs = decoder_outputs(rng, L, Q)
    arrs[1] = 1 / (1 + np.exp(-arrs[1]))  # sigmoid boxes
    want = jdn.dn_post_process(*(jnp.asarray(a) for a in arrs), jmd)
    got = dn.dn_post_process(*(torch.from_numpy(a) for a in arrs), md)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (L, B, Q - pad, w.shape[-1])
        close(g, w)
    for g, w in zip(md["output_known_lbs_bboxes"], jmd["output_known_lbs_bboxes"]):
        close(g, w)
    want_l = jdn.compute_dn_loss(jmd, training=True, aux_num=2)
    got_l = dn.compute_dn_loss(md, training=True, aux_num=2)
    assert got_l.keys() == want_l.keys() and len(got_l) == 15
    for k in want_l:
        np.testing.assert_allclose(got_l[k].item(), float(want_l[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_prepare_for_dn_shapes_and_noise():
    """tests/test_dn.py:test_prepare_for_dn_shapes_and_noise on the port,
    with the noise drawn from a torch.Generator, and the draws' bounds."""
    rng = np.random.RandomState(0)
    targets = torch_targets(make_targets(rng))
    table = torch.from_numpy(rng.randn(C + 1, HID - 1).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    q, ref, attn_mask, md = dn.prepare_for_dn(gen, targets, table, scalar=S, num_classes=C)
    assert q.shape == (B, S * T, HID) and ref.shape == (B, S * T, 6)
    assert md["pad_size"] == S * T and md["scalar"] == S
    assert attn_mask.shape == (S * T, S * T) and attn_mask.dtype == torch.bool
    valid = md["known_valid"]
    assert (q[~valid] == 0).all()  # invalid slots are zeroed
    assert (q[valid][:, -1] == 1.0).all()  # the denoising indicator
    s = torch.sigmoid(ref[valid])  # noised boxes stay in [0, 1]
    assert s.min() >= 0.0 and s.max() <= 1.0
    # each coordinate moves by at most box_noise_scale times its extent
    boxes = md["known_boxes"][valid]
    extent = torch.stack([(boxes[:, 2] + boxes[:, 3]) / 2, (boxes[:, 4] + boxes[:, 5]) / 2,
                          boxes[:, 2], boxes[:, 3], boxes[:, 4], boxes[:, 5]], -1)
    assert ((s - boxes).abs() <= 0.4 * extent + 1e-4).all()
    # the same generator state gives the same queries
    again = dn.prepare_for_dn(torch.Generator().manual_seed(0), targets, table, scalar=S,
                              num_classes=C)
    assert torch.equal(again[0], q) and torch.equal(again[1], ref)
    # the labels' embeddings: every valid query is a row of the table
    rows = q[valid][:, :-1]
    assert ((rows[:, None] - table[None]).abs().sum(-1) == 0).any(-1).all()


def test_dn_attn_mask_structure():
    pad, single, match = 6, 2, 4
    m = dn.dn_attn_mask(pad, single, match).numpy()
    assert m[pad:, :pad].all()  # match queries cannot see dn queries
    assert not m[pad:, pad:].any()  # match queries see each other
    assert not m[0, 1]  # a dn group sees itself, not the others
    assert m[0, 2] and m[0, 4]
    assert not m[2, 3] and m[2, 0]


def test_post_process_split():
    rng = np.random.RandomState(1)
    L, Q, pad = 3, 10, 4
    arrs = [torch.from_numpy(a) for a in decoder_outputs(rng, L, Q)]
    md = {"pad_size": pad}
    outs = dn.dn_post_process(*arrs, md)
    assert outs[0].shape == (L, B, Q - pad, 3)
    assert md["output_known_lbs_bboxes"][0].shape == (L, B, pad, 3)
    assert torch.equal(outs[1], arrs[1][:, :, pad:])
    # no denoising part: the outputs as they are
    assert all(o is a for o, a in zip(dn.dn_post_process(*arrs, {"pad_size": 0}), arrs))


def test_compute_dn_loss_finite_and_zero_paths():
    rng = np.random.RandomState(2)
    targets = torch_targets(make_targets(rng))
    table = torch.from_numpy(rng.randn(C + 1, HID - 1).astype(np.float32))
    *_, md = dn.prepare_for_dn(torch.Generator().manual_seed(0), targets, table, scalar=S,
                               num_classes=C)
    pad, L = md["pad_size"], 3
    arrs = [torch.from_numpy(a) for a in decoder_outputs(rng, L, pad)]
    arrs[1] = torch.sigmoid(arrs[1])
    md["output_known_lbs_bboxes"] = tuple(arrs)
    losses = dn.compute_dn_loss(md, training=True, aux_num=2)
    assert all(torch.isfinite(v) for v in losses.values())
    assert "tgt_loss_ce" in losses and "tgt_loss_ce_1" in losses
    for md_, training in ((None, False), (None, True), (md, False), ({"pad_size": 0}, True)):
        z = dn.compute_dn_loss(md_, training=training, aux_num=2)
        assert len(z) == 15 and all(float(v) == 0.0 for v in z.values())
