"""Position embeddings (monodetr_tpu/models/position_encoding.py).

The sine table: inputs have fixed shapes and all-valid masks, so the
reference's cumsum-over-not-mask reduces to a static table built in numpy.
The learned one (`position_embedding: learned` or `v3`): two 50-row tables
interpolated linearly to the level's size."""

import torch
from torch import nn

from ..ops.utils import device_constant, sine_position_encoding


def sine_pos_table(h, w, hidden_dim, device="cpu"):
    """[h, w, hidden_dim] static sine position table (normalize=True), f32."""
    return device_constant(sine_position_encoding, (h, w, hidden_dim // 2), torch.device(device))


class LearnedPositionEmbedding(nn.Module):
    """50 x F learned tables per axis, interpolated to any size
    (position_encoding.py:23-51, reference position_encoding.py:59-86); the
    reference's `row_embed` / `col_embed` embeddings, initialised uniform
    on [0, 1)."""

    def __init__(self, num_pos_feats=128):
        super().__init__()
        self.row_embed = nn.Embedding(50, num_pos_feats)
        self.col_embed = nn.Embedding(50, num_pos_feats)

    @staticmethod
    def _interp(table, n):
        """table at n points arange(n) / n * 49: floor, the upper index
        clipped at 49, blended linearly, in f32 as the JAX module is."""
        coord = torch.arange(n, dtype=torch.float32, device=table.device) / n * 49
        floor_c = torch.floor(coord)
        delta = (coord - floor_c)[:, None]
        f = floor_c.long()
        c = (f + 1).clamp(max=49)
        t = table.float()
        return t[f] * (1 - delta) + t[c] * delta

    def forward(self, h, w):
        """[h, w, 2F] f32: [x embedding | y embedding] at every position."""
        x_emb = self._interp(self.col_embed.weight, w)  # [w, F]
        y_emb = self._interp(self.row_embed.weight, h)  # [h, F]
        F_ = x_emb.shape[1]
        return torch.cat([x_emb[None].expand(h, w, F_), y_emb[:, None].expand(h, w, F_)], -1)
