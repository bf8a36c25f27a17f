"""Multi-head attention, dropout(softmax(q k^T * scale)) v.

Counterpart of monodetr_tpu/ops/attention_pallas.py:fused_attention, same
signature and [B, H, T, D] layout.  The CUDA kernels are
csrc/attention.cu: attention_fwd_kernel and the backward pair
attention_bwd_dq_kernel / attention_bwd_dkv_kernel, joined by an
autograd.Function.  Dropout is inverted dropout on the normalised
probabilities with a keep mask that is a pure function of (seed, position)
(Philox4x32-10 in the kernels), so the backward regenerates it.

`attention_plain` is their plain PyTorch version: f32 logits, f32
softmax, probabilities cast to v's dtype, then the keep mask and 1/(1-p)
(layers.py:125-137 and attention_pallas.py:47-76), and P.V; its gradients
come from autograd.  `attention_keep_mask` returns the mask the kernels
draw, so that the two can be held against each other with dropout on.
"""

import torch

from .. import _build
from ..utils.trace import count


def attention_plain(q, k, v, scale, keep=None, dropout_p=0.0):
    """keep: optional bool mask [B, H, Tq, Tk] of the kept probabilities,
    which are scaled by 1 / (1 - dropout_p)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    if keep is not None:
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0).to(v.dtype)
    return torch.matmul(probs, v)


def _threshold(dropout_p):
    """Keep a probability when its 32 random bits are >= this."""
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    return min(int(dropout_p * 2 ** 32), 2 ** 32 - 1)


def _seed_arg(seed, device):
    """The seed as an int64 tensor on `device` (a tensor drawn there from a
    generator stays there)."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.device != device or seed.is_floating_point():
            raise ValueError("seed must be one integer on the inputs' device")
        return seed.reshape(()).to(torch.int64)
    return torch.tensor(int(seed), dtype=torch.int64, device=device)


def _check(name, q, k, v):
    _build.require_cuda(name, q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    return B, H, Tq, Tk, D


def _launch_fwd(q, k, v, seed_t, scale, dropout_p):
    B, H, Tq, Tk, D = _check("fused_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    thr = _threshold(dropout_p)
    _build.launch(
        "mdt_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _build.dtype_code(q.dtype), B * H, Tq, Tk,
        D, float(scale), seed_t.data_ptr() if thr else None, thr,
        _build.stream_of(q))
    count("attention_fwd")
    return out, lse


def fused_attention_bwd(q, k, v, out, lse, gout, seed, scale, dropout_p):
    """The backward kernels on CUDA tensors: (dq, dk, dv) for the output
    gradient `gout`, given the forward's `out` and log-sum-exp `lse`
    [B, H, Tq] f32, and the forward's seed and dropout_p."""
    name = "fused_attention_bwd"
    B, H, Tq, Tk, D = _check(name, q, k, v)
    gout = gout.contiguous()
    if gout.shape != q.shape or gout.dtype != q.dtype or out.shape != q.shape:
        raise ValueError(f"{name}: gout {tuple(gout.shape)} {gout.dtype}")
    _build.require_cuda(name, q, out, gout, lse)
    thr = _threshold(dropout_p)
    seed_t = _seed_arg(seed, q.device) if thr else None
    delta = torch.empty(B, H, Tq, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.launch(
        "mdt_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), gout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _build.dtype_code(q.dtype),
        B * H, Tq, Tk, D, float(scale),
        seed_t.data_ptr() if thr else None, thr, _build.stream_of(q))
    count("attention_bwd")
    return dq, dk, dv


def attention_keep_mask(shape, seed, dropout_p, device):
    """The bool keep mask [B, H, Tq, Tk] that the CUDA kernels draw for
    `seed` and `dropout_p`."""
    B, H, Tq, Tk = shape
    thr = _threshold(dropout_p)
    out = torch.empty(B, H, Tq, Tk, dtype=torch.uint8, device=device)
    seed_t = _seed_arg(seed, out.device)
    _build.require_cuda("attention_keep_mask", out, seed_t)
    _build.launch("mdt_attention_keep_mask", out.data_ptr(), B * H, Tq, Tk,
                  seed_t.data_ptr(), thr, _build.stream_of(out))
    return out.bool()


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed_t, scale, dropout_p):
        out, lse = _launch_fwd(q, k, v, seed_t, scale, dropout_p)
        ctx.save_for_backward(q, k, v, out, lse, seed_t)
        ctx.consts = (scale, dropout_p)
        return out

    @staticmethod
    def backward(ctx, gout):
        q, k, v, out, lse, seed_t = ctx.saved_tensors
        scale, dropout_p = ctx.consts
        dq, dk, dv = fused_attention_bwd(q, k, v, out, lse, gout, seed_t, scale,
                                         dropout_p)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, seed, scale, dropout_p):
    """q [B, H, Tq, D], k/v [B, H, Tk, D] -> [B, H, Tq, D] in q.dtype.

    `seed` (an int, or one integer in a tensor on the inputs' device)
    selects the dropout mask when dropout_p > 0.  Differentiable in q, k
    and v.  On the CPU the plain version runs, with a keep mask drawn from
    torch.Generator().manual_seed(seed)."""
    if q.device.type == "cpu":
        keep = None
        if dropout_p > 0.0:
            gen = torch.Generator().manual_seed(int(seed))
            B, H, Tq, _ = q.shape
            keep = torch.rand(B, H, Tq, k.shape[2], generator=gen) >= dropout_p
        return attention_plain(q, k, v, scale, keep, dropout_p)
    seed_t = _seed_arg(seed, q.device) if dropout_p > 0.0 else None
    return _Attention.apply(q, k, v, seed_t, float(scale), float(dropout_p))
