"""Depth-aware transformer: visual encoder over the multi-scale tokens and
the depth-guided decoder with iterative 6-D box refinement
(monodetr_tpu/models/transformer.py, reference depthaware_transformer.py),
the standard query configuration, eval and training: in training the
decoder runs all num_queries * group_num queries with group-wise
self-attention (transformer.py:161-175) and every dropout of
transformer.py:104-188 draws from the generator passed down.

As in the reference, the value of decoder self-attention is the raw `tgt`
(the reference computes sa_v_proj and then overwrites it,
depthaware_transformer.py:471 vs :477), so sa_v_proj does not exist here.
Masks are all-valid at fixed input shapes, so valid ratios are 1.
"""

import numpy as np
import torch
from torch import nn

from ..ops.utils import device_constant, inverse_sigmoid
from .layers import MultiheadAttention, dropout, ffn
from .msda_module import MSDeformAttn


def encoder_reference_points(spatial_shapes):
    """Per-level pixel-centre grids, normalised, [S, 2] (x, y)
    (reference :364-376 with valid_ratios == 1)."""
    pts = []
    for h, w in spatial_shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return np.concatenate(pts, axis=0)


class VisualEncoderLayer(nn.Module):
    def __init__(self, d_model=256, d_ffn=256, n_levels=4, n_heads=8, n_points=4,
                 msda_impl="gather", msda_window=8, dropout=0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      impl=msda_impl, window=msda_window)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes, gen=None):
        p = self.dropout
        src2 = self.self_attn(src + pos, reference_points, src, spatial_shapes)
        src = self.norm1(src + dropout(src2, p, gen))
        return ffn(src, self.linear1, self.linear2, self.norm2, p, gen)


class DepthAwareDecoderLayer(nn.Module):
    def __init__(self, d_model=256, d_ffn=256, n_levels=4, n_heads=8, n_points=4,
                 msda_impl="sep", dropout=0.1, group_num=11, num_queries=50):
        super().__init__()
        self.dropout = dropout
        self.group_num, self.num_queries = group_num, num_queries
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points, impl=msda_impl)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn_depth = MultiheadAttention(d_model, n_heads, dropout)
        self.norm_depth = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = MultiheadAttention(d_model, n_heads, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.sa_qcontent_proj = nn.Linear(d_model, d_model)
        self.sa_qpos_proj = nn.Linear(d_model, d_model)
        self.sa_kcontent_proj = nn.Linear(d_model, d_model)
        self.sa_kpos_proj = nn.Linear(d_model, d_model)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes, depth_embed,
                gen=None):
        """`gen`: the dropout generator in training, else None.  With
        group_num * num_queries queries (the training forward),
        self-attention runs within each group of num_queries."""
        p = self.dropout
        # (1) depth cross-attention: raw tgt queries x depth tokens (:456-462)
        tgt2 = self.cross_attn_depth(tgt, depth_embed, depth_embed, gen)
        tgt = self.norm_depth(tgt + dropout(tgt2, p, gen))
        # (2) self-attention (:465-503); both projections of each pair read
        # tgt + query_pos, as in JAX
        qk = tgt + query_pos
        q = self.sa_qcontent_proj(qk) + self.sa_qpos_proj(qk)
        k = self.sa_kcontent_proj(qk) + self.sa_kpos_proj(qk)
        B, Q, C = tgt.shape
        g, nq = self.group_num, self.num_queries
        if Q == g * nq:
            def regroup(x):
                return x.reshape(B * g, nq, C)

            tgt2 = self.self_attn(regroup(q), regroup(k), regroup(tgt), gen).reshape(B, Q, C)
        else:
            tgt2 = self.self_attn(q, k, tgt, gen)
        tgt = self.norm2(tgt + dropout(tgt2, p, gen))
        # (3) deformable cross-attention into the encoder memory (:506-508)
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, src, spatial_shapes)
        tgt = self.norm1(tgt + dropout(tgt2, p, gen))
        return ffn(tgt, self.linear1, self.linear2, self.norm3, p, gen)


class _Layers(nn.Module):
    """`layers` as in the reference's encoder and decoder containers."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DepthAwareTransformer(nn.Module):
    """Encoder + decoder + query/reference machinery.  The per-layer bbox
    and 3-D size heads are owned by MonoDETR and passed to forward (the
    reference shares them between refinement and output decoding)."""

    def __init__(self, d_model=256, nhead=8, num_encoder_layers=3, num_decoder_layers=3,
                 dim_feedforward=256, num_feature_levels=4, enc_n_points=4, dec_n_points=4,
                 two_stage=False, use_dab=False, two_stage_dino=False,
                 msda_impl="gather", msda_window=8, dec_msda_impl="sep", dropout=0.1,
                 group_num=11, num_queries=50):
        super().__init__()
        for flag, on in (("two_stage", two_stage), ("use_dab", use_dab),
                         ("two_stage_dino", two_stage_dino)):
            if on:
                raise NotImplementedError(
                    f"{flag} is not ported; the standard query path is "
                    "(ROADMAP.md section A, variants)")
        self.d_model = d_model
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, d_model))
        self.reference_points = nn.Linear(d_model, 2)
        self.encoder = _Layers(
            VisualEncoderLayer(d_model, dim_feedforward, num_feature_levels, nhead,
                               enc_n_points, msda_impl, msda_window, dropout)
            for _ in range(num_encoder_layers))
        self.decoder = _Layers(
            DepthAwareDecoderLayer(d_model, dim_feedforward, num_feature_levels, nhead,
                                   dec_n_points, dec_msda_impl, dropout, group_num,
                                   num_queries)
            for _ in range(num_decoder_layers))

    def forward(self, srcs, pos_embeds, query_embed, depth_embed, bbox_heads, dim_heads,
                gen=None):
        """srcs / pos_embeds: per level [B, h, w, C] (NHWC views);
        query_embed: [Q, 2C]; depth_embed: [B, S16, C]; gen: the dropout
        generator in training, else None.

        Returns (hs [Ldec, B, Q, C], refs_in per layer, inter_dims
        [Ldec, B, Q, 3] f32)."""
        B = srcs[0].shape[0]
        C = self.d_model
        spatial_shapes = tuple((s.shape[1], s.shape[2]) for s in srcs)
        dtype = srcs[0].dtype
        memory = torch.cat([s.reshape(B, -1, C) for s in srcs], 1)
        pos_flat = torch.cat(
            [p.reshape(B, -1, C) + self.level_embed[l] for l, p in enumerate(pos_embeds)],
            1).to(dtype)

        enc_ref = device_constant(encoder_reference_points, (spatial_shapes,), memory.device)
        enc_ref = enc_ref[None, :, None, :].expand(B, -1, len(spatial_shapes), 2)
        for layer in self.encoder.layers:
            memory = layer(memory, pos_flat, enc_ref, spatial_shapes, gen)

        query_pos, tgt = query_embed.to(dtype).split(C, dim=1)
        query_pos = query_pos[None].expand(B, -1, -1)
        tgt = tgt[None].expand(B, -1, -1)
        with torch.autocast(memory.device.type, enabled=False):  # f32, as in JAX
            reference_points = torch.sigmoid(nn.functional.linear(
                query_pos.float(), self.reference_points.weight.float(),
                self.reference_points.bias.float()))

        hs, refs_in, dims = [], [], []
        for lid, layer in enumerate(self.decoder.layers):
            ref_dim = reference_points.shape[-1]
            ref_input = reference_points[:, :, None, :].expand(-1, -1, len(spatial_shapes), ref_dim)
            tgt = layer(tgt, query_pos, ref_input, memory, spatial_shapes, depth_embed, gen)
            hs.append(tgt)
            refs_in.append(reference_points)
            dims.append(dim_heads[lid](tgt).float())
            # iterative refinement, detached (:601-613)
            tmp = bbox_heads[lid](tgt).float()
            if ref_dim == 6:
                new_ref = tmp + inverse_sigmoid(reference_points)
            else:
                new_ref = torch.cat([tmp[..., :2] + inverse_sigmoid(reference_points),
                                     tmp[..., 2:]], -1)
            reference_points = torch.sigmoid(new_ref).detach()
        return torch.stack(hs), refs_in, torch.stack(dims)
