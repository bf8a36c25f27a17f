"""Shared building blocks (monodetr_tpu/models/layers.py): the ReLU MLP
head, torch-compatible multi-head attention over [B, T, C], conv + GroupNorm,
the post-norm FFN, and dropout.

Dropout is flax's nn.Dropout: x / (1 - p) where kept, P(keep) = 1 - p.
Every random draw comes from an explicit torch.Generator passed down the
forward (`gen`); with gen None (evaluation) dropout is the identity.
`checkpoint_with_gen` rematerialises a region that draws from such a
generator."""

from torch import nn
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention_plain, fused_attention

# attention with more logits than this per (batch, head) runs in the fused
# kernel (layers.py:98-100): the depth encoder's 1920 x 1920 and, in
# training, the decoder's 550 x 1920 depth cross-attention
FUSED_ATTENTION_MIN_LOGITS = 1_000_000


def dropout(x, p, gen):
    """Inverted dropout with the keep mask drawn from `gen` (on x's
    device); the identity when gen is None or p == 0."""
    if gen is None or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


def checkpoint_with_gen(fn, *args, gen=None):
    """fn(*args, gen) under torch.utils.checkpoint (non-reentrant): its
    activations are recomputed in the backward.  checkpoint's own
    preserve_rng_state saves the default generators only, so the region's
    draws from `gen` are kept here: the recompute starts from the state the
    forward started from, and so draws the same dropout masks, and then
    puts `gen` back where the backward found it.  A step with the region
    rematerialised thus leaves `gen` where the step without leaves it."""
    if gen is None:
        return checkpoint(fn, *args, None, use_reentrant=False, preserve_rng_state=False)
    start = []

    def run(*a):
        if not start:  # the forward
            start.append(gen.get_state())
            return fn(*a, gen)
        after = gen.get_state()  # the recompute, in the backward
        gen.set_state(start[0])
        try:
            return fn(*a, gen)
        finally:
            gen.set_state(after)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class MLP(nn.Module):
    """ReLU MLP head (reference monodetr.py:535-547)."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims, outs))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiheadAttention(nn.Module):
    """softmax(Q K^T / sqrt(d_head)) V with nn.MultiheadAttention's packed
    in-projection parameters; no masks (every caller's mask is all-valid).
    In training (`gen` given) dropout p applies to the probabilities after
    their cast to the compute dtype (layers.py:125-137); the fused kernel
    draws its mask from a seed taken from `gen`.

    `plain_ops` selects the plain PyTorch attention over the fused kernel
    for a CUDA tensor, for comparing the two."""

    def __init__(self, d_model, num_heads, dropout=0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.plain_ops = False

    def forward(self, q, k, v, gen=None):
        B, Tq, C = q.shape
        Tk = k.shape[1]
        w_q, w_k, w_v = self.in_proj_weight.chunk(3)
        b_q, b_k, b_v = self.in_proj_bias.chunk(3)

        def heads(x, w, b, T):
            return F.linear(x, w, b).view(B, T, self.num_heads, -1).transpose(1, 2).contiguous()

        qh, kh, vh = heads(q, w_q, b_q, Tq), heads(k, w_k, b_k, Tk), heads(v, w_v, b_v, Tk)
        scale = qh.shape[-1] ** -0.5
        p = self.dropout if gen is not None else 0.0
        if Tq * Tk > FUSED_ATTENTION_MIN_LOGITS and not self.plain_ops:
            seed = (torch.randint(0, 2 ** 31 - 1, (), generator=gen, device=q.device)
                    if p > 0.0 else 0)
            out = fused_attention(qh, kh, vh, seed, scale, p)
        else:
            keep = None
            if p > 0.0:
                keep = torch.rand(B, self.num_heads, Tq, Tk, generator=gen,
                                  device=q.device) >= p
            out = attention_plain(qh, kh, vh, scale, keep, p)
        return self.out_proj(out.transpose(1, 2).reshape(B, Tq, C))


def conv_gn(cin, cout, kernel=1, stride=1, groups=32):
    """Conv2d + GroupNorm(32), the reference's projection block
    (monodetr.py:83-91); as nn.Sequential so the names are `.0` / `.1`."""
    return nn.Sequential(
        nn.Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2),
        nn.GroupNorm(groups, cout, eps=1e-5))


def ffn(x, linear1, linear2, norm, p=0.0, gen=None):
    """Post-norm FFN block: norm(x + dropout(linear2(dropout(relu(linear1(x))))))
    (layers.py:218-224, depthaware_transformer.py:339-343)."""
    h = dropout(F.relu(linear1(x)), p, gen)
    return norm(x + dropout(linear2(h), p, gen))
