"""Depth-aware transformer: visual encoder over the multi-scale tokens and
the depth-guided decoder with iterative 6-D box refinement
(monodetr_tpu/models/transformer.py, reference depthaware_transformer.py),
eval and training: in training the decoder runs all num_queries *
group_num queries with group-wise self-attention (transformer.py:161-175)
and every dropout of transformer.py:104-188 draws from the generator
passed down.

The decoder's queries come from one of four configurations
(transformer.py:283-366): the standard learned queries with references
from a linear layer; `two_stage`, the top-k of the encoder's tokens scored
by the extra head set, embedded by pos_trans; `use_dab`, learned content
and 6-D anchor references; `two_stage_dino`, top-k encoder proposals as
references with a learned content table.  DAB and DINO recompute each
decoder layer's query position from the sine embedding of its reference.
The proposal branches and DAB's references compute in f32 whatever the
compute dtype, as in JAX (autocast off, explicit casts).

As in the reference, the value of decoder self-attention is the raw `tgt`
(the reference computes sa_v_proj and then overwrites it,
depthaware_transformer.py:471 vs :477), so sa_v_proj does not exist here.
Masks are all-valid at fixed input shapes, so valid ratios are 1.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.utils import device_constant, inverse_sigmoid
from .layers import MLP, MultiheadAttention, checkpoint_with_gen, dropout, ffn
from .msda_module import MSDeformAttn

QUERY_VARIANTS = ("two_stage", "use_dab", "two_stage_dino")


def _sine_dim_t():
    """10000^(2 floor(i / 2) / 128), i < 128, in f32 as the JAX helpers make it."""
    dim_t = np.arange(128, dtype=np.float32)
    return (10000.0 ** (2 * (dim_t // 2) / 128)).astype(np.float32)


def _sin_cos(p):
    """[..., 128] -> sin of the even, cos of the odd entries, interleaved."""
    return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], -1).flatten(-2)


def gen_sineembed_for_position(pos):
    """Sine embedding of normalised positions [B, Q, d] (d = 2 or 6) ->
    [B, Q, 128 d], in the order y, x, then l, r, t, b (transformer.py:
    35-52, reference depthaware_transformer.py:29-65)."""
    dim_t = device_constant(_sine_dim_t, (), pos.device)

    def embed(coord):
        return _sin_cos(coord[..., None] * (2 * math.pi) / dim_t)

    order = [1, 0] + list(range(2, pos.shape[-1]))
    return torch.cat([embed(pos[..., i]) for i in order], -1)


def get_proposal_pos_embed(proposals):
    """[B, Q, 4] unactivated proposals -> [B, Q, 512] sine embedding, the
    sigmoid inside (transformer.py:55-66, reference :139-152)."""
    dim_t = device_constant(_sine_dim_t, (), proposals.device)
    p = torch.sigmoid(proposals) * (2 * math.pi)
    return _sin_cos(p[..., None] / dim_t).flatten(-2)


def encoder_output_proposals(spatial_shapes):
    """Static per-level box proposals [S, 6] (cx, cy, and 0.05 * 2^level for
    l, r, t, b) in logit space, +inf where a proposal leaves (0.01, 0.99),
    and that validity mask [S] (transformer.py:69-86, reference
    gen_encoder_output_proposals :154-188 with valid ratios 1)."""
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        wh = np.full((h * w, 4), 0.05 * (2.0 ** lvl), np.float32)
        props.append(np.concatenate([gx.reshape(-1, 1), gy.reshape(-1, 1), wh], axis=1))
    proposals = np.concatenate(props, axis=0)
    valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1)
    unact = np.log(proposals / (1 - proposals))
    unact = np.where(valid[:, None], unact, np.inf).astype(np.float32)
    return unact, valid


def _proposal_logits(spatial_shapes):
    return encoder_output_proposals(spatial_shapes)[0]


def _proposal_valid(spatial_shapes):
    return encoder_output_proposals(spatial_shapes)[1]


def linear_f32(x, layer):
    return F.linear(x.float(), layer.weight.float(), layer.bias.float())


def layer_norm_f32(x, norm):
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps)


def mlp_f32(x, mlp):
    for i, layer in enumerate(mlp.layers):
        x = linear_f32(x, layer)
        if i < len(mlp.layers) - 1:
            x = F.relu(x)
    return x


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
    """With `remat` (the config's `remat: encoder`, `True` or `all`), a
    training forward keeps the sampled output of its deformable attention
    and recomputes the rest in the backward, as the JAX layer's
    save_only_these_names("msda_sampled") policy does (transformer.py:
    263-271): two checkpointed regions, the projections before the sampling
    and the output projection, norms and FFN after it; the sampling op runs
    between them once, and its output is the second region's saved input.
    The op's autograd node keeps its inputs (value, offsets, weights).  The
    second region's dropout masks are drawn again in the recompute from the
    generator state its forward started from (checkpoint_with_gen)."""

    def __init__(self, d_model=256, d_ffn=256, n_levels=4, n_heads=8, n_points=4,
                 msda_impl="gather", msda_window=8, dropout=0.1, remat=False):
        super().__init__()
        self.dropout = dropout
        self.remat = remat
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      impl=msda_impl, window=msda_window)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes, gen=None):
        attn = self.self_attn
        if not (self.remat and torch.is_grad_enabled()):
            op, args = attn.sampling(src + pos, reference_points, src, spatial_shapes)
            return self._after_sampling(src, op(*args), gen)
        op, args = checkpoint(
            lambda s, q: attn.sampling(s + q, reference_points, s, spatial_shapes), src, pos,
            use_reentrant=False, preserve_rng_state=False)
        return checkpoint_with_gen(self._after_sampling, src, op(*args), gen=gen)

    def _after_sampling(self, src, sampled, gen):
        p = self.dropout
        src2 = self.self_attn.output_proj(sampled.to(src.dtype))
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
    """Encoder + decoder + query/reference machinery.  The per-layer class,
    bbox and 3-D size heads are owned by MonoDETR and passed to forward
    (the reference shares them between refinement and output decoding;
    `two_stage` scores the encoder's proposals with the last class and
    bbox head, the extra set).  At most one of `two_stage`, `use_dab`,
    `two_stage_dino` is set; `num_queries` is also the proposal count."""

    def __init__(self, d_model=256, nhead=8, num_encoder_layers=3, num_decoder_layers=3,
                 dim_feedforward=256, num_feature_levels=4, enc_n_points=4, dec_n_points=4,
                 two_stage=False, use_dab=False, two_stage_dino=False,
                 msda_impl="gather", msda_window=8, dec_msda_impl="sep", dropout=0.1,
                 group_num=11, num_queries=50, remat=False):
        super().__init__()
        if two_stage + use_dab + two_stage_dino > 1:
            raise ValueError(f"at most one of {', '.join(QUERY_VARIANTS)} may be set")
        self.d_model = d_model
        self.two_stage, self.use_dab, self.two_stage_dino = two_stage, use_dab, two_stage_dino
        self.group_num, self.num_queries = group_num, num_queries
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, d_model))
        self.encoder = _Layers(
            VisualEncoderLayer(d_model, dim_feedforward, num_feature_levels, nhead,
                               enc_n_points, msda_impl, msda_window, dropout, remat)
            for _ in range(num_encoder_layers))
        self.decoder = _Layers(
            DepthAwareDecoderLayer(d_model, dim_feedforward, num_feature_levels, nhead,
                                   dec_n_points, dec_msda_impl, dropout, group_num,
                                   num_queries)
            for _ in range(num_decoder_layers))
        if two_stage or two_stage_dino:
            self.enc_output = nn.Linear(d_model, d_model)
            self.enc_output_norm = nn.LayerNorm(d_model, eps=1e-5)
        if two_stage:
            self.pos_trans = nn.Linear(2 * d_model, 2 * d_model)
            self.pos_trans_norm = nn.LayerNorm(2 * d_model, eps=1e-5)
        elif two_stage_dino:
            self.enc_out_class_embed = nn.Linear(d_model, 3)
            self.enc_out_bbox_embed = MLP(d_model, d_model, 6, 3)
            self.tgt_embed = nn.Embedding(num_queries * group_num, d_model)
        elif not use_dab:
            self.reference_points = nn.Linear(d_model, 2)
        if use_dab or two_stage_dino:
            # on the decoder, as the reference names them; the sine
            # embedding of a 6-D reference is 6 x 128 wide
            self.decoder.ref_point_head = MLP(6 * 128, d_model, d_model, 2)
            self.decoder.query_scale = MLP(d_model, d_model, d_model, 2)

    def forward(self, srcs, pos_embeds, query_embed, depth_embed, bbox_heads, dim_heads,
                gen=None, class_heads=None, train=False, proposal_idx=None):
        """srcs / pos_embeds: per level [B, h, w, C] (NHWC views);
        query_embed: [Q, 2C] (standard), [Q, C + 6] (use_dab) or None;
        depth_embed: [B, S16, C]; gen: the dropout generator in training,
        else None; class_heads: the class heads (read by `two_stage`);
        train: the training forward (`two_stage_dino` then takes
        num_queries * group_num proposals); proposal_idx: [B, K] token
        indices that the proposal variants take instead of their own top-k
        (None but in a check that holds two runs to the same picks).

        Returns (hs [Ldec, B, Q, C], refs_in per layer, inter_dims
        [Ldec, B, Q, 3] f32, enc_outputs_class [B, S, 3] and
        enc_outputs_coord_unact [B, S, 6], both f32 and None unless
        two_stage, and the proposal indices [B, K], None unless
        two_stage or two_stage_dino)."""
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

        enc_class = enc_coord = idx = None
        if self.two_stage or self.two_stage_dino:
            proposals = device_constant(_proposal_logits, (spatial_shapes,), memory.device)
            valid = device_constant(_proposal_valid, (spatial_shapes,), memory.device)
            with torch.autocast(memory.device.type, enabled=False):
                mem = torch.where(valid[None, :, None], memory.float(), 0.0)
                out_mem = layer_norm_f32(linear_f32(mem, self.enc_output), self.enc_output_norm)
                if self.two_stage:
                    # applied twice, as the reference does (:187 and :236-237)
                    out_mem = layer_norm_f32(linear_f32(out_mem, self.enc_output),
                                             self.enc_output_norm)
                else:
                    enc_coord = mlp_f32(out_mem, self.enc_out_bbox_embed) + proposals
                    scores = linear_f32(out_mem, self.enc_out_class_embed).max(-1).values
            if self.two_stage:  # the extra head set, in the compute dtype
                enc_class = class_heads[-1](out_mem.to(dtype)).float()
                enc_coord = bbox_heads[-1](out_mem.to(dtype)).float() + proposals
                scores = enc_class[..., 0]
            n_q = self.num_queries * (self.group_num if train and self.two_stage_dino else 1)
            # tiny inputs can have fewer tokens than proposals
            if proposal_idx is None:
                idx = scores.topk(min(n_q, scores.shape[1]), dim=1).indices
            else:
                idx = proposal_idx
            ref_unact = torch.gather(enc_coord, 1, idx[..., None].expand(-1, -1, 6)).detach()
            reference_points = torch.sigmoid(ref_unact)
            if self.two_stage:
                # (cx, cy, l + r, t + b) -> (query_pos, tgt)
                coords4 = torch.cat([ref_unact[..., 0:2],
                                     ref_unact[..., 2::2] + ref_unact[..., 3::2]], -1)
                with torch.autocast(memory.device.type, enabled=False):
                    pos_tgt = layer_norm_f32(
                        linear_f32(get_proposal_pos_embed(coords4), self.pos_trans),
                        self.pos_trans_norm)
                query_pos, tgt = pos_tgt.to(dtype).split(C, dim=-1)
            else:
                enc_coord = None  # DINO returns no encoder outputs
                tgt = self.tgt_embed.weight[:idx.shape[1]].to(dtype)[None].expand(B, -1, -1)
        elif self.use_dab:
            with torch.autocast(memory.device.type, enabled=False):
                anchors = query_embed.float()
                reference_points = torch.sigmoid(anchors[None, :, C:]).expand(B, -1, -1)
            tgt = anchors[None, :, :C].expand(B, -1, -1).to(dtype)
        else:
            query_pos, tgt = query_embed.to(dtype).split(C, dim=1)
            query_pos = query_pos[None].expand(B, -1, -1)
            tgt = tgt[None].expand(B, -1, -1)
            with torch.autocast(memory.device.type, enabled=False):  # f32, as in JAX
                reference_points = torch.sigmoid(linear_f32(query_pos, self.reference_points))
        per_layer_query_pos = self.use_dab or self.two_stage_dino

        hs, refs_in, dims = [], [], []
        for lid, layer in enumerate(self.decoder.layers):
            ref_dim = reference_points.shape[-1]
            ref_input = reference_points[:, :, None, :].expand(-1, -1, len(spatial_shapes), ref_dim)
            if per_layer_query_pos:
                # the sine embedding of the current reference (:384-408)
                query_pos = self.decoder.ref_point_head(
                    gen_sineembed_for_position(reference_points).to(dtype))
                if lid != 0:
                    query_pos = self.decoder.query_scale(tgt) * query_pos
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
        return torch.stack(hs), refs_in, torch.stack(dims), enc_class, enc_coord, idx
