"""Foreground depth predictor and depth encoder
(monodetr_tpu/models/depth_predictor.py, reference
depth_predictor/depth_predictor.py): fuse the 1/8, 1/16 and 1/32 levels on
the 1/16 grid, a conv-GN-ReLU head, LID-bin logits, the expected depth map,
one post-norm transformer layer over the 1/16 tokens (with its dropouts in
training, depth_predictor.py:30-45), and the learned 1-D depth position
table lerped at the predicted depth."""

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.utils import device_constant, interpolate_1d_embed, lid_bin_values
from .layers import LayerNorm, MultiheadAttention, conv_gn, dropout, forward_dtype


class DepthEncoderLayer(nn.Module):
    """Post-norm transformer encoder layer (depth_predictor/transformer.py:36-65)."""

    def __init__(self, d_model=256, nhead=8, dim_feedforward=256, dropout=0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadAttention(d_model, nhead, dropout)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, gen=None):
        p = self.dropout
        q = src + pos
        src = self.norm1(src + dropout(self.self_attn(q, q, src, gen), p, gen))
        h = dropout(F.relu(self.linear1(src)), p, gen)
        return self.norm2(src + dropout(self.linear2(h), p, gen))


class DepthEncoder(nn.Module):
    """`layers` as in the reference's TransformerEncoder (one layer)."""

    def __init__(self, d_model, dropout=0.1):
        super().__init__()
        self.layers = nn.ModuleList([DepthEncoderLayer(d_model, dropout=dropout)])

    def forward(self, src, pos, gen=None):
        for layer in self.layers:
            src = layer(src, pos, gen)
        return src


class DepthPredictor(nn.Module):
    def __init__(self, d_model=256, num_depth_bins=80, depth_min=1e-3, depth_max=60.0,
                 dropout=0.1):
        super().__init__()
        self.depth_max = depth_max
        self.proj = conv_gn(d_model, d_model, 1)
        self.upsample = conv_gn(d_model, d_model, 1)
        self.downsample = conv_gn(d_model, d_model, 3, stride=2)
        self.depth_head = nn.Sequential(
            *conv_gn(d_model, d_model, 3), nn.ReLU(),
            *conv_gn(d_model, d_model, 3), nn.ReLU())
        self.depth_classifier = nn.Conv2d(d_model, num_depth_bins + 1, 1)
        self.depth_encoder = DepthEncoder(d_model, dropout)
        self.depth_pos_embed = nn.Embedding(int(depth_max) + 1, 256)
        # f32 whatever dtype the module is cast to (bin centres reach 60 m)
        self.bins = (num_depth_bins, depth_min, depth_max)

    def forward(self, srcs, pos_16, gen=None):
        """srcs: projected features [B, C, h, w] of levels 1/8, 1/16, 1/32
        (and 1/64, unused); pos_16: [B, h16*w16, C] tokens; gen: the
        dropout generator in training, else None.

        Returns (depth_logits [B, h16, w16, bins+1] f32,
                 depth_embed tokens [B, h16*w16, C],
                 weighted_depth [B, h16, w16] f32,
                 depth_pos_embed_ip tokens [B, h16*w16, C])."""
        f8, f16, f32 = srcs[0], srcs[1], srcs[2]
        B, C, h16, w16 = f16.shape
        dtype = forward_dtype(f16.device, self.proj[0].weight.dtype)
        src_16 = self.proj(f16)
        # jax.image.resize bilinear == align_corners=False with clamped edges;
        # CUDA autocast returns f32 from it, JAX the compute dtype
        up32 = F.interpolate(f32, size=(h16, w16), mode="bilinear",
                             align_corners=False).to(dtype)
        src_32 = self.upsample(up32)
        src_8 = self.downsample(f8)
        src = self.depth_head((src_8 + src_16 + src_32) / 3)

        depth_logits = self.depth_classifier(src).float().permute(0, 2, 3, 1)
        depth_probs = torch.softmax(depth_logits, dim=-1)
        weighted_depth = (depth_probs * device_constant(lid_bin_values, self.bins, src.device)).sum(-1)

        tokens = src.permute(0, 2, 3, 1).reshape(B, h16 * w16, C)
        depth_embed = self.depth_encoder(tokens, pos_16, gen)

        d = weighted_depth.clamp(0.0, self.depth_max)
        table = self.depth_pos_embed.weight.float()
        depth_pos_embed_ip = interpolate_1d_embed(d, table).reshape(B, h16 * w16, C)
        depth_pos_embed_ip = depth_pos_embed_ip.to(dtype)
        return depth_logits, depth_embed + depth_pos_embed_ip, weighted_depth, depth_pos_embed_ip
