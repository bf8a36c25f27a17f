"""Multi-head attention forward, softmax(q k^T * scale) v.

Counterpart of monodetr_tpu/ops/attention_pallas.py:fused_attention, same
signature and [B, H, T, D] layout.  The CUDA kernel is
csrc/attention.cu:attention_fwd_kernel; `attention_plain` is its plain
PyTorch version: f32 logits, f32 softmax, probabilities cast to v's dtype
before P.V (layers.py:129-137 and attention_pallas.py:73-76).
"""

import torch

from .. import _build


def attention_plain(q, k, v, scale):
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def fused_attention(q, k, v, seed, scale, dropout_p):
    """q [B, H, Tq, D], k/v [B, H, Tk, D] -> [B, H, Tq, D] in q.dtype.

    `seed` feeds the dropout stream, which only training uses: dropout and
    this kernel's backward come with the training path (ROADMAP.md A8)."""
    if dropout_p > 0.0:
        raise NotImplementedError(
            "fused_attention: dropout_p > 0 (in-kernel Philox dropout and the "
            "backward that regenerates its mask) is not ported yet; see "
            "ROADMAP.md section B, kernel 3")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    name = "fused_attention"
    _build.require_cuda(name, q, k, v)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, D) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    out = torch.empty_like(q)
    _build.launch(
        "mdt_attention_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), _build.dtype_code(q.dtype), B * H, Tq, Tk, D,
        float(scale), _build.stream_of(q))
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
