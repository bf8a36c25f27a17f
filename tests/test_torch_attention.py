"""The attention kernel's plain version against the JAX package (the
kernel against its plain version on the card: tests/test_torch_cuda.py).

fused_attention's plain version is held against the interpret-mode Pallas
fused_attention at p = 0, and the port's MultiheadAttention module against
the flax module on both sides of the fused-kernel threshold
(layers.py:98-100).  Tolerance in f32: rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monodetr_tpu.models.layers import MultiheadAttention as JaxMHA
from monodetr_tpu.ops.attention_pallas import fused_attention as jax_fused_attention
from monodetr_torch.models.layers import MultiheadAttention
from monodetr_torch.ops.attention import fused_attention

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-5
SCALE = 1.0 / np.sqrt(32)


def qkv(rng, B=1, H=2, Tq=50, Tk=96, D=32):
    return (rng.randn(B, H, Tq, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32))


@pytest.mark.parametrize("tq", [50, 128, 130])
def test_plain_matches_pallas_kernel(tq):
    q, k, v = qkv(np.random.RandomState(tq), Tq=tq)
    want = jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.int32(0), SCALE, 0.0)
    got = fused_attention(*(torch.from_numpy(x) for x in (q, k, v)), 0, SCALE, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_dropout_is_not_ported():
    """Dropout is ported: on the CPU, fused_attention at p > 0 is the plain
    version with a keep mask drawn from torch.Generator().manual_seed(seed)
    (the kernel's Philox mask is held to it on the card), a function of the
    seed, with inverted scaling."""
    q, k, v = (torch.from_numpy(x) for x in qkv(np.random.RandomState(0)))
    got = fused_attention(q, k, v, 1, SCALE, 0.1)
    keep = torch.rand(1, 2, 50, 96, generator=torch.Generator().manual_seed(1)) >= 0.1
    probs = torch.softmax(q @ k.transpose(-1, -2) * SCALE, -1)
    want = torch.where(keep, probs / 0.9, 0.0) @ v
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, fused_attention(q, k, v, 1, SCALE, 0.1))
    assert not torch.equal(got, fused_attention(q, k, v, 2, SCALE, 0.1))


@pytest.mark.parametrize("tq,tk", [(50, 40), (1100, 1000)])  # below / above 1e6 logits
def test_mha_module_matches_flax(tq, tk):
    rng = np.random.RandomState(tq)
    C = 64
    q = rng.randn(2, tq, C).astype(np.float32)
    k = rng.randn(2, tk, C).astype(np.float32)
    v = rng.randn(2, tk, C).astype(np.float32)
    jm = JaxMHA(num_heads=8)
    params = jm.init(jax.random.PRNGKey(0), q, k, v)["params"]
    params = jax.tree_util.tree_map(
        lambda x: x + 0.1 * rng.randn(*x.shape).astype(np.float32), params)  # nonzero biases
    want = jax.jit(lambda p: jm.apply({"params": p}, q, k, v))(params)

    tm = MultiheadAttention(C, 8)
    with torch.no_grad():
        tm.in_proj_weight.copy_(torch.from_numpy(np.array(params["in_proj_kernel"]).T))
        tm.in_proj_bias.copy_(torch.from_numpy(np.array(params["in_proj_bias"])))
        tm.out_proj.weight.copy_(torch.from_numpy(np.array(params["out_proj"]["kernel"]).T))
        tm.out_proj.bias.copy_(torch.from_numpy(np.array(params["out_proj"]["bias"])))
        got = tm(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
