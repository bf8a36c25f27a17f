"""Plain float32 MonoDETR: the benchmark's reference for the forward pass.

MonoDETR (Zhang et al., ICCV 2023; github.com/ZrrSkywalker/MonoDETR) as
its published description and `configs/monodetr.yaml` define it, in plain
PyTorch operations: ResNet-50 or -101 with frozen batch norm, four
projected levels, the foreground depth predictor with its one-layer depth
encoder, three visual encoder layers of deformable attention, three
depth-aware decoder layers with iterative 6-D box refinement, and the
per-layer heads with the three-way depth fusion.  The parameter names are
the published checkpoint's `state_dict` keys, so one state dict loads into
this model and into the program under test.

Departures from the published code, each one the configuration's own:
  - the encoder's deformable attention samples inside a window: every
    offset is clamped to +-(G/2 - 1 - 0.01) pixels of the sampled level
    around the query's centre there (`msda_window` G), then sampled exactly
    (bilinear, zero padding);
  - in training the decoder runs `group_num` groups of `num_queries`
    queries, self-attention within each group;
  - dropout masks follow a generator given from outside (`Drops`), so
    that a run can be repeated draw for draw.

Nothing here imports the program or any kernel.  Every matrix product and
convolution rounds its operands and its output through `self.prec`, and
every norm its output (identity in float32; `Fp8` for the precision
control).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention import attention

STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
CHANNELS = (512, 1024, 2048)
FROZEN_PREFIXES = ("backbone.0.body.conv1.", "backbone.0.body.layer1.")


def f32(x):
    return x


class Fp8:
    """Round a product's operand to float8 e4m3 with one scale per tensor
    (its largest magnitude to 448); the gradient passes straight through."""

    def __call__(self, x):
        amax = x.detach().abs().amax().float().clamp(min=1e-12)
        scale = 448.0 / amax
        q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
        return x + (q - x).detach()


class Linear(nn.Linear):
    prec = staticmethod(f32)

    def forward(self, x):
        return self.prec(F.linear(self.prec(x), self.prec(self.weight), self.bias))


class Conv2d(nn.Conv2d):
    prec = staticmethod(f32)

    def forward(self, x):
        return self.prec(F.conv2d(self.prec(x), self.prec(self.weight), self.bias,
                                  self.stride, self.padding, self.dilation))


class FrozenBatchNorm2d(nn.Module):
    def __init__(self, n):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            self.register_buffer(name, torch.full((n,), fill))

    def forward(self, x):
        scale = self.weight * (self.running_var + 1e-5).rsqrt()
        bias = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + bias[None, :, None, None]


class Bottleneck(nn.Module):
    def __init__(self, cin, width, stride, downsample):
        super().__init__()
        self.conv1 = Conv2d(cin, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(width * 4)
        self.downsample = nn.Sequential(
            Conv2d(cin, width * 4, 1, stride=stride, bias=False),
            FrozenBatchNorm2d(width * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class ResNetBody(nn.Module):
    def __init__(self, name):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin, width = 64, 64
        for stage, n in enumerate(STAGE_BLOCKS[name]):
            blocks = [Bottleneck(cin if b == 0 else width * 4, width,
                                 (1 if stage == 0 else 2) if b == 0 else 1, b == 0)
                      for b in range(n)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            cin, width = width * 4, width * 2

    def forward(self, x):
        with torch.no_grad():  # the stem and layer1 never train
            x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, stride=2, padding=1)
            x = self.layer1(x)
        f8 = self.layer2(x)
        f16 = self.layer3(f8)
        return f8, f16, self.layer4(f16)


class Backbone(nn.Module):
    def __init__(self, name):
        super().__init__()
        self.body = ResNetBody(name)


def conv_gn(cin, cout, k=1, stride=1):
    return nn.Sequential(Conv2d(cin, cout, k, stride=stride, padding=k // 2),
                         nn.GroupNorm(32, cout, eps=1e-5))


def sine_table(h, w, feats=128):
    """Normalised sine position table [h, w, 2 feats] of an all-valid mask."""
    y = np.arange(1, h + 1, dtype=np.float64)[:, None].repeat(w, 1)
    x = np.arange(1, w + 1, dtype=np.float64)[None, :].repeat(h, 0)
    y = y / (h + 1e-6) * 2 * math.pi
    x = x / (w + 1e-6) * 2 * math.pi
    dim_t = 10000.0 ** (2 * (np.arange(feats) // 2) / feats)

    def embed(v):
        p = v[:, :, None] / dim_t
        return np.stack([np.sin(p[:, :, 0::2]), np.cos(p[:, :, 1::2])], 3).reshape(h, w, -1)

    return np.concatenate([embed(y), embed(x)], 2).astype(np.float32)


def lid_bin_values(num_bins, depth_min, depth_max):
    bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
    idx = np.arange(num_bins, dtype=np.float64)
    vals = (idx + 0.5) ** 2 * bin_size / 2 - bin_size / 8 + depth_min
    return np.concatenate([vals, [depth_max]]).astype(np.float32)


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


class MultiheadAttention(nn.Module):
    """Packed in-projection attention over [B, T, C]; `drops` supplies the
    dropout of the probabilities."""

    def __init__(self, d, heads, p):
        super().__init__()
        self.heads, self.p = heads, p
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = Linear(d, d)

    def forward(self, q, k, v, drops=None, per_item=1):
        B, Tq, C = q.shape
        Tk = k.shape[1]
        w = self.in_proj_weight.chunk(3)
        b = self.in_proj_bias.chunk(3)
        prec = self.out_proj.prec

        def heads(x, i, T):
            y = F.linear(prec(x), prec(w[i]), b[i])
            return y.view(B, T, self.heads, -1).transpose(1, 2)

        qh, kh, vh = heads(q, 0, Tq), heads(k, 1, Tk), heads(v, 2, Tk)
        keep = drops.attention((B, self.heads, Tq, Tk), per_item) if drops else None
        out = attention(prec(qh), prec(kh), prec(vh), qh.shape[-1] ** -0.5, keep, self.p,
                        prec)
        return self.out_proj(out.transpose(1, 2).reshape(B, Tq, C))


def ffn(x, l1, l2, norm, p, drops):
    h = drop(F.relu(l1(x)), p, drops)
    return norm(x + drop(l2(h), p, drops))


def drop(x, p, drops):
    if drops is None or p == 0.0:
        return x
    return torch.where(drops.elementwise(x.shape), x / (1.0 - p), 0.0)


class DepthEncoderLayer(nn.Module):
    def __init__(self, d, heads, p):
        super().__init__()
        self.p = p
        self.self_attn = MultiheadAttention(d, heads, p)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = Linear(d, d)
        self.linear2 = Linear(d, d)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, src, pos, drops):
        q = src + pos
        src = self.norm1(src + drop(self.self_attn(q, q, src, drops), self.p, drops))
        return ffn(src, self.linear1, self.linear2, self.norm2, self.p, drops)


class DepthEncoder(nn.Module):
    def __init__(self, d, heads, p):
        super().__init__()
        self.layers = nn.ModuleList([DepthEncoderLayer(d, heads, p)])


class DepthPredictor(nn.Module):
    def __init__(self, d, bins, depth_min, depth_max, heads, p):
        super().__init__()
        self.depth_max = depth_max
        self.bins = (bins, depth_min, depth_max)
        self.proj = conv_gn(d, d)
        self.upsample = conv_gn(d, d)
        self.downsample = conv_gn(d, d, 3, 2)
        self.depth_head = nn.Sequential(*conv_gn(d, d, 3), nn.ReLU(), *conv_gn(d, d, 3),
                                        nn.ReLU())
        self.depth_classifier = Conv2d(d, bins + 1, 1)
        self.depth_encoder = DepthEncoder(d, heads, p)
        self.depth_pos_embed = nn.Embedding(int(depth_max) + 1, d)

    def forward(self, f8, f16, f32_, pos16, drops):
        B, C, h, w = f16.shape
        up = F.interpolate(f32_, size=(h, w), mode="bilinear", align_corners=False)
        src = self.depth_head((self.downsample(f8) + self.proj(f16) + self.upsample(up)) / 3)
        logits = self.depth_classifier(src).permute(0, 2, 3, 1)
        values = torch.from_numpy(lid_bin_values(*self.bins)).to(src.device)
        weighted = (torch.softmax(logits, -1) * values).sum(-1)
        tokens = src.permute(0, 2, 3, 1).reshape(B, h * w, C)
        embed = self.depth_encoder.layers[0](tokens, pos16, drops)
        d = weighted.clamp(0.0, self.depth_max)
        lo = torch.floor(d)
        frac = (d - lo)[..., None]
        table = self.depth_pos_embed.weight
        i0 = lo.long()
        i1 = (i0 + 1).clamp(max=table.shape[0] - 1)
        ip = (table[i0] * (1 - frac) + table[i1] * frac).reshape(B, h * w, C)
        return logits, embed + ip, weighted


def level_starts(shapes):
    return np.cumsum([0] + [h * w for h, w in shapes[:-1]]).tolist()


def sample(value, shapes, fx, fy, att):
    """Bilinear sampling (zero padding) at pixel positions fx, fy
    [B, Q, H, L, P] of each level, weighted by att and summed over levels
    and points: value [B, S, H, D] -> [B, Q, H * D]."""
    B, S, H, D = value.shape
    Q, P = fx.shape[1], fx.shape[4]
    out = 0
    for lid, ((h, w), s0) in enumerate(zip(shapes, level_starts(shapes))):
        v = value[:, s0:s0 + h * w].permute(0, 2, 3, 1).reshape(B * H, D, h, w)
        gx = (fx[:, :, :, lid] + 0.5) * (2.0 / w) - 1.0
        gy = (fy[:, :, :, lid] + 0.5) * (2.0 / h) - 1.0
        grid = torch.stack([gx, gy], -1).transpose(1, 2).reshape(B * H, Q, P, 2)
        s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
        a = att[:, :, :, lid].transpose(1, 2).reshape(B * H, 1, Q, P)
        out = out + (s * a).sum(-1)
    return out.reshape(B, H, D, Q).permute(0, 3, 1, 2).reshape(B, Q, H * D)


def grid_centres(shapes):
    """[S, L, 2]: each grid query's centre in every level's pixels."""
    per = []
    for hq, wq in shapes:
        ys, xs = np.meshgrid(np.arange(hq) + 0.5, np.arange(wq) + 0.5, indexing="ij")
        per.append(np.stack([np.stack([xs * wv / wq - 0.5, ys * hv / hq - 0.5], -1)
                             .reshape(-1, 2) for hv, wv in shapes], 1))
    return np.concatenate(per, 0).astype(np.float32)


class MSDeformAttn(nn.Module):
    def __init__(self, d, levels, heads, points, window=None):
        super().__init__()
        self.L, self.H, self.P, self.window = levels, heads, points, window
        self.sampling_offsets = Linear(d, heads * levels * points * 2)
        self.attention_weights = Linear(d, heads * levels * points)
        self.value_proj = Linear(d, d)
        self.output_proj = Linear(d, d)

    def forward(self, query, ref, tokens, shapes):
        """ref: None for grid queries (windowed), else [B, Q, 2] centres or
        [B, Q, 6] cxcylrtb boxes, normalised."""
        B, Q, C = query.shape
        H, L, P = self.H, self.L, self.P
        value = self.value_proj(tokens).view(B, -1, H, C // H)
        off = self.sampling_offsets(query).view(B, Q, H, L, P, 2)
        att = torch.softmax(self.attention_weights(query).view(B, Q, H, L * P), -1)
        att = att.view(B, Q, H, L, P)
        if ref is None:
            lim = self.window / 2 - 1 - 1e-2
            c = torch.from_numpy(grid_centres(shapes)).to(query.device)
            o = off.clamp(-lim, lim)
            fx = c[None, :, None, :, None, 0] + o[..., 0]
            fy = c[None, :, None, :, None, 1] + o[..., 1]
        else:
            wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                              device=query.device)
            r = ref[:, :, None, None, None, :]
            if ref.shape[-1] == 2:
                loc = r + off / wh[None, None, None, :, None, :]
            else:
                ext = (r[..., 2::2] + r[..., 3::2]) * 0.5
                loc = r[..., :2] + off / P * ext
            f = loc * wh[None, None, None, :, None, :] - 0.5
            fx, fy = f[..., 0], f[..., 1]
        return self.output_proj(sample(value, shapes, fx, fy, att))


class EncoderLayer(nn.Module):
    def __init__(self, d, levels, heads, points, window, p):
        super().__init__()
        self.p = p
        self.self_attn = MSDeformAttn(d, levels, heads, points, window)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = Linear(d, d)
        self.linear2 = Linear(d, d)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, src, pos, shapes, drops):
        src2 = self.self_attn(src + pos, None, src, shapes)
        src = self.norm1(src + drop(src2, self.p, drops))
        return ffn(src, self.linear1, self.linear2, self.norm2, self.p, drops)


class DecoderLayer(nn.Module):
    def __init__(self, d, levels, heads, points, p, groups, nq):
        super().__init__()
        self.p, self.groups, self.nq = p, groups, nq
        self.cross_attn = MSDeformAttn(d, levels, heads, points)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.cross_attn_depth = MultiheadAttention(d, heads, p)
        self.norm_depth = nn.LayerNorm(d, eps=1e-5)
        self.self_attn = MultiheadAttention(d, heads, p)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        for n in ("sa_qcontent_proj", "sa_qpos_proj", "sa_kcontent_proj", "sa_kpos_proj",
                  "linear1", "linear2"):
            setattr(self, n, Linear(d, d))
        self.norm3 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, tgt, qpos, ref, memory, shapes, depth_embed, drops):
        p = self.p
        tgt = self.norm_depth(tgt + drop(
            self.cross_attn_depth(tgt, depth_embed, depth_embed, drops), p, drops))
        qk = tgt + qpos
        q = self.sa_qcontent_proj(qk) + self.sa_qpos_proj(qk)
        k = self.sa_kcontent_proj(qk) + self.sa_kpos_proj(qk)
        B, Q, C = tgt.shape
        if Q == self.groups * self.nq:  # training: self-attention within each group
            g = self.groups
            tgt2 = self.self_attn(q.reshape(B * g, -1, C), k.reshape(B * g, -1, C),
                                  tgt.reshape(B * g, -1, C), drops, g).reshape(B, Q, C)
        else:
            tgt2 = self.self_attn(q, k, tgt, drops)
        tgt = self.norm2(tgt + drop(tgt2, p, drops))
        tgt = self.norm1(tgt + drop(self.cross_attn(tgt + qpos, ref, memory, shapes), p, drops))
        return ffn(tgt, self.linear1, self.linear2, self.norm3, p, drops)


class Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Transformer(nn.Module):
    def __init__(self, m):
        super().__init__()
        d, heads, L = m["hidden_dim"], m["nheads"], m["num_feature_levels"]
        p = m["dropout"]
        self.d = d
        self.level_embed = nn.Parameter(torch.empty(L, d))
        self.encoder = Layers(EncoderLayer(d, L, heads, m["enc_n_points"], m["msda_window"], p)
                              for _ in range(m["enc_layers"]))
        self.decoder = Layers(DecoderLayer(d, L, heads, m["dec_n_points"], p, m["group_num"],
                                           m["num_queries"]) for _ in range(m["dec_layers"]))


class MonoDETR(nn.Module):
    """model(images [B, H, W, 3], calibs [B, 3, 4], img_sizes [B, 2],
    train, drops) -> (the outputs of every decoder layer, the depth map's
    logits, None: the proposals of a query path that picks them).

    A reference of another query path subclasses this one: it names the
    query flags it holds (`QUERIES`), adds its query parameters in
    `add_queries` and builds its queries in `forward`, around `encode` and
    `head`."""

    # (two_stage, use_dab, two_stage_dino)
    QUERIES = (False, False, False)
    PATH = "the standard MonoDETR path"

    def __init__(self, m):
        super().__init__()
        if (m["backbone"] not in STAGE_BLOCKS or m["dilation"]
                or (m["two_stage"], m["use_dab"], m["two_stage_dino"]) != self.QUERIES
                or m["position_embedding"] != "sine"
                or not m["with_box_refine"] or m["init_box"] or m["num_feature_levels"] != 4):
            raise ValueError(f"the reference holds {self.PATH} only")
        d = m["hidden_dim"]
        self.m = m
        self.backbone = nn.ModuleList([Backbone(m["backbone"])])
        self.input_proj = nn.ModuleList([conv_gn(c, d) for c in CHANNELS]
                                        + [conv_gn(CHANNELS[-1], d, 3, 2)])
        self.depth_predictor = DepthPredictor(d, m["num_depth_bins"], float(m["depth_min"]),
                                              float(m["depth_max"]), m["nheads"], m["dropout"])
        self.depthaware_transformer = Transformer(m)
        self.add_queries(m)
        n = m["dec_layers"]
        self.class_embed = nn.ModuleList(Linear(d, m["num_classes"]) for _ in range(n))
        self.bbox_embed = nn.ModuleList(MLP(d, 6, 3) for _ in range(n))
        self.dim_embed_3d = nn.ModuleList(MLP(d, 3, 2) for _ in range(n))
        self.angle_embed = nn.ModuleList(MLP(d, 24, 2) for _ in range(n))
        self.depth_embed = nn.ModuleList(MLP(d, 2, 2) for _ in range(n))

    def add_queries(self, m):
        """The standard path's learned queries and the linear layer that
        makes their 2-D references."""
        d = m["hidden_dim"]
        self.depthaware_transformer.reference_points = Linear(d, 2)
        self.query_embed = nn.Embedding(m["num_queries"] * m["group_num"], 2 * d)

    def set_precision(self, prec):
        """Round with `prec` every product's operands and output and every
        tensor a module returns (norms, blocks, layers, heads): the tensors
        a lower-precision program keeps in that precision."""
        def rounded(module, args, out):
            return prec(out) if torch.is_tensor(out) else out

        for mod in self.modules():
            if isinstance(mod, (Linear, Conv2d)):
                mod.prec = prec
            elif prec is not f32 and mod is not self:
                mod.register_forward_hook(rounded)
        return self

    def encode(self, images, drops):
        """The backbone, the depth predictor and the encoder: (memory
        [B, S, C], the levels' (h, w), the depth embedding, the weighted
        depth map, the depth logits)."""
        d = self.d_model
        f8, f16, f32_ = self.backbone[0].body(images.permute(0, 3, 1, 2))
        srcs = [self.input_proj[i](f) for i, f in enumerate((f8, f16, f32_))]
        srcs.append(self.input_proj[3](f32_))
        shapes = [tuple(s.shape[2:]) for s in srcs]
        pos = [torch.from_numpy(sine_table(h, w, d // 2)).to(images.device) for h, w in shapes]
        logits_d, depth_embed, weighted = self.depth_predictor(
            srcs[0], srcs[1], srcs[2], pos[1].reshape(1, -1, d), drops)
        tr = self.depthaware_transformer
        memory = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        pos_flat = torch.cat([p.reshape(-1, d) + tr.level_embed[l] for l, p in enumerate(pos)])
        for layer in tr.encoder.layers:
            memory = layer(memory, pos_flat[None], shapes, drops)
        return memory, shapes, depth_embed, weighted, logits_d

    def head(self, lid, tgt, ref, calibs, img_sizes, weighted):
        """Decoder layer lid's outputs from its queries `tgt` and the
        reference `ref` it sampled around; its pred_boxes, detached, are
        the next layer's reference."""
        fy = calibs[:, 0, 0][:, None]
        size3d = self.dim_embed_3d[lid](tgt)
        tmp = self.bbox_embed[lid](tgt)
        unact = inverse_sigmoid(ref)
        if ref.shape[-1] == 6:
            tmp = tmp + unact
        else:
            tmp = torch.cat([tmp[..., :2] + unact, tmp[..., 2:]], -1)
        coord = torch.sigmoid(tmp)
        height = ((coord[:, :, 4] + coord[:, :, 5]) * img_sizes[:, 1:2]).clamp(min=1.0)
        depth_geo = size3d[:, :, 0] / height * fy
        depth_reg = self.depth_embed[lid](tgt)
        centres = ((coord[..., :2] - 0.5) * 2).detach()
        depth_map = F.grid_sample(weighted[:, None], centres[:, :, None, :],
                                  mode="bilinear", padding_mode="zeros",
                                  align_corners=True)[:, 0, :, 0]
        depth_ave = (1.0 / (torch.sigmoid(depth_reg[:, :, 0]) + 1e-6) - 1.0
                     + depth_geo + depth_map) / 3
        return {"pred_logits": self.class_embed[lid](tgt), "pred_boxes": coord,
                "pred_3d_dim": size3d,
                "pred_depth": torch.stack([depth_ave, depth_reg[:, :, 1]], -1),
                "pred_angle": self.angle_embed[lid](tgt)}

    def forward(self, images, calibs, img_sizes, train=False, drops=None):
        m, d = self.m, self.d_model
        B = images.shape[0]
        memory, shapes, depth_embed, weighted, logits_d = self.encode(images, drops)
        tr = self.depthaware_transformer
        q = self.query_embed.weight
        if not train:
            q = q[:m["num_queries"]]
        qpos, tgt = q[None].expand(B, -1, -1).split(d, dim=-1)
        ref = torch.sigmoid(tr.reference_points(qpos))
        outs = []
        for lid, layer in enumerate(tr.decoder.layers):
            tgt = layer(tgt, qpos, ref, memory, shapes, depth_embed, drops)
            outs.append(self.head(lid, tgt, ref, calibs, img_sizes, weighted))
            ref = outs[-1]["pred_boxes"].detach()
        return outs, logits_d, None

    @property
    def d_model(self):
        return self.m["hidden_dim"]


class MLP(nn.Module):
    """n linear layers of width d with ReLU between; the first takes d_in
    features (d by default), the last gives out."""

    def __init__(self, d, out, n, d_in=None):
        super().__init__()
        self.layers = nn.ModuleList(Linear(d_in or d if i == 0 else d, d if i < n - 1 else out)
                                    for i in range(n))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def build(model_cfg, device="cpu", net=MonoDETR):
    """The reference model (`net`) of a configuration's `model` keys, on
    `device`, its parameters uninitialised (load a state dict into it)."""
    m = dict(model_cfg)
    m.setdefault("group_num", 11)
    with torch.device(device):
        return net(m)


def trained(name):
    """Whether the optimizer updates the parameter `name`."""
    return not name.startswith(FROZEN_PREFIXES)
