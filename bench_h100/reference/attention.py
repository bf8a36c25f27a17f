"""softmax(q k^T * scale) v with dropout on the probabilities, in blocks of
query rows so that no [Tq, Tk] matrix of all heads is ever whole in memory.

`keep` is None (no dropout) or an object whose `block(r0, r1)` gives the
bool keep mask [B, H, r1 - r0, Tk] of those rows; kept probabilities are
scaled by 1 / (1 - p).  The backward recomputes each block's probabilities
from the saved log-sum-exp and uses dS = P (dP - rowsum(dO o O)), which
holds with dropout too.
"""

import torch

BLOCK_ELEMENTS = 1 << 25  # logits of one block: B * H * rows * Tk


def _rows(q, k):
    B, H, Tq, _ = q.shape
    return max(1, min(Tq, BLOCK_ELEMENTS // max(1, B * H * k.shape[2])))


def _probs(q, k, scale, lse=None):
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if lse is None:
        lse = torch.logsumexp(s, -1)
    return torch.exp(s - lse[..., None]), lse


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, keep, p, prec):
        B, H, Tq, _ = q.shape
        rows = _rows(q, k)
        out = torch.empty_like(q)
        lse = torch.empty(B, H, Tq, dtype=q.dtype, device=q.device)
        for r0 in range(0, Tq, rows):
            r1 = min(Tq, r0 + rows)
            pr, lse[:, :, r0:r1] = _probs(q[:, :, r0:r1], k, scale)
            pr = prec(pr)
            if keep is not None:
                pr = torch.where(keep.block(r0, r1), pr / (1.0 - p), 0.0)
            out[:, :, r0:r1] = torch.matmul(pr, v)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, keep, p, rows)
        return out

    @staticmethod
    def backward(ctx, gout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, keep, p, rows = ctx.args
        delta = (gout * out).sum(-1)
        dq = torch.empty_like(q)
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(v)
        for r0 in range(0, q.shape[2], rows):
            r1 = min(q.shape[2], r0 + rows)
            qb, gb = q[:, :, r0:r1], gout[:, :, r0:r1]
            pr, _ = _probs(qb, k, scale, lse[:, :, r0:r1])
            dpd = torch.matmul(gb, v.transpose(-1, -2))
            if keep is not None:
                m = keep.block(r0, r1)
                pd = torch.where(m, pr / (1.0 - p), 0.0)
                dp = torch.where(m, dpd / (1.0 - p), 0.0)
            else:
                pd, dp = pr, dpd
            dv += torch.matmul(pd.transpose(-1, -2), gb)
            ds = pr * (dp - delta[:, :, r0:r1, None])
            dq[:, :, r0:r1] = torch.matmul(ds, k) * scale
            dk += torch.matmul(ds.transpose(-1, -2), qb) * scale
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, scale, keep=None, p=0.0, prec=lambda x: x):
    """q [B, H, Tq, D], k and v [B, H, Tk, D] -> [B, H, Tq, D]."""
    return _Attention.apply(q, k, v, scale, keep, p, prec)
