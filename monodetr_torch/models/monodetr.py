"""MonoDETR: backbone -> input projections -> depth predictor ->
depth-aware transformer -> per-layer heads with three-way depth fusion
(monodetr_tpu/models/monodetr.py, reference monodetr.py:150-283), the eval
and training forward, with ResNet-50 or ResNet-101 (`backbone`), with or
without `dilation`, sine or learned position embeddings, the JAX model's
`remat` scopes (check_remat) and its query configurations: the standard
learned queries, `two_stage`, `use_dab` and `two_stage_dino`
(models/transformer.py).

Parameter names are the reference checkpoint's `state_dict` keys, so
convert.py and tools/convert_checkpoint.py map them to and from the JAX
parameter tree.  With `two_stage` the class and bbox heads have one set
more than the decoder has layers (the extra set scores the encoder's
proposals); the size, angle and depth heads do not, as in the JAX tree
(monodetr.py:167-186, where flax makes the parameters of a called head
only).  Run the model in a compute dtype by casting it
(`model.to(dtype)`); the places where the JAX model computes in f32
whatever its dtype (reference points, the proposal branches, depth logits
and bins, the heads' outputs and the depth fusion) are f32 here too.
Training keeps f32 parameters and computes in bf16 under torch.autocast
(train/train_step.py).
"""

import math

import torch
from torch import nn

from ..ops.utils import grid_sample_bilinear, inverse_sigmoid
from .backbone import BACKBONE_NUM_CHANNELS, FrozenBatchNorm2d, ResNetBackbone
from .depth_predictor import DepthPredictor
from .layers import MLP, MultiheadAttention, conv_gn
from .msda_module import MSDeformAttn
from .position_encoding import LearnedPositionEmbedding, sine_pos_table
from .transformer import DepthAwareTransformer


class MonoDETR(nn.Module):
    def __init__(self, num_classes=3, num_queries=50, num_feature_levels=4, group_num=11,
                 hidden_dim=256, backbone_name="resnet50", dilation=False, enc_layers=3,
                 dec_layers=3, nheads=8, dim_feedforward=256, enc_n_points=4, dec_n_points=4,
                 num_depth_bins=80, depth_min=1e-3, depth_max=60.0, with_box_refine=True,
                 init_box=False, two_stage=False, use_dab=False, two_stage_dino=False,
                 position_embedding="sine", msda_impl="gather", msda_window=8,
                 dec_msda_impl="sep", dropout=0.1, remat=False):
        super().__init__()
        if position_embedding not in ("sine", "learned", "v3"):
            raise ValueError(f"position_embedding {position_embedding!r} is not one of "
                             "'sine', 'learned', 'v3'")
        if num_feature_levels != 4:
            raise ValueError("MonoDETR uses the 3 backbone levels and one extra level")
        self.num_queries = num_queries
        self.hidden_dim = hidden_dim
        self.dec_layers = dec_layers
        self.with_box_refine, self.init_box = with_box_refine, init_box
        self.two_stage, self.use_dab = two_stage, use_dab
        self.query_free = two_stage or two_stage_dino
        scopes = check_remat(remat)
        # backbone.0 the ResNet, backbone.1 the learned position embedding
        # (the reference's Joiner; the sine table has no parameters)
        self.backbone = nn.ModuleList(
            [ResNetBackbone(backbone_name, dilation, "backbone" in scopes)]
            + ([LearnedPositionEmbedding(hidden_dim // 2)]
               if position_embedding in ("learned", "v3") else []))
        self.input_proj = nn.ModuleList(
            [conv_gn(c, hidden_dim, 1) for c in BACKBONE_NUM_CHANNELS]
            + [conv_gn(BACKBONE_NUM_CHANNELS[-1], hidden_dim, 3, stride=2)])
        self.depth_predictor = DepthPredictor(hidden_dim, num_depth_bins, depth_min, depth_max)
        self.depthaware_transformer = DepthAwareTransformer(
            hidden_dim, nheads, enc_layers, dec_layers, dim_feedforward, num_feature_levels,
            enc_n_points, dec_n_points, two_stage, use_dab, two_stage_dino,
            msda_impl, msda_window, dec_msda_impl, dropout, group_num, num_queries,
            remat="encoder" in scopes)
        # query parameters per configuration (monodetr.py:131-143)
        if use_dab:
            self.tgt_embed = nn.Embedding(num_queries * group_num, hidden_dim)
            self.refpoint_embed = nn.Embedding(num_queries * group_num, 6)
        elif not self.query_free:
            self.query_embed = nn.Embedding(num_queries * group_num, 2 * hidden_dim)
        n_pred = dec_layers + 1 if two_stage else dec_layers
        self.class_embed = nn.ModuleList(
            nn.Linear(hidden_dim, num_classes) for _ in range(n_pred))
        self.bbox_embed = nn.ModuleList(
            MLP(hidden_dim, hidden_dim, 6, 3) for _ in range(n_pred))
        self.dim_embed_3d = nn.ModuleList(
            MLP(hidden_dim, hidden_dim, 3, 2) for _ in range(dec_layers))
        self.angle_embed = nn.ModuleList(
            MLP(hidden_dim, hidden_dim, 24, 2) for _ in range(dec_layers))
        self.depth_embed = nn.ModuleList(
            MLP(hidden_dim, hidden_dim, 2, 2) for _ in range(dec_layers))

    def use_plain_ops(self, plain=True):
        """Route every kernel call of the model to its plain PyTorch
        version (True) or back to the kernels (False)."""
        for m in self.modules():
            if isinstance(m, (MSDeformAttn, MultiheadAttention)):
                m.plain_ops = plain
        return self

    def forward(self, images, calibs, img_sizes, train=False, gen=None, proposal_idx=None):
        """images [B, H, W, 3] normalised (NHWC, as the JAX model takes
        them); calibs [B, 3, 4] P2; img_sizes [B, 2] original (w, h).
        train: all num_queries * group_num queries (monodetr.py:235-240;
        two_stage always takes num_queries proposals), else the first
        num_queries; gen: the torch.Generator (on the images' device) that
        every dropout draws from, None for no dropout; proposal_idx: the
        proposal variants' top-k token indices [B, K] to take instead of
        their own (a check's argument: it holds a second run to the
        first run's picks, which near-tied scores may otherwise reorder).
        Returns pred_logits / pred_boxes / pred_3d_dim / pred_depth /
        pred_angle / pred_depth_map_logits / weighted_depth / aux_outputs,
        and with two_stage enc_outputs (the proposals' logits and sigmoid
        boxes, monodetr.py:324-328); with two_stage or two_stage_dino
        proposal_idx, the top-k token indices the decoder's queries came
        from."""
        dtype = self.depthaware_transformer.level_embed.dtype
        # NHWC memory seen as NCHW: channels_last, no copy
        x = images.to(dtype).permute(0, 3, 1, 2)
        feats = self.backbone[0](x)
        srcs = [self.input_proj[i](feats[i]) for i in range(3)]
        srcs.append(self.input_proj[3](feats[2]))
        B = images.shape[0]
        if len(self.backbone) > 1:  # learned
            pos = [self.backbone[1](s.shape[2], s.shape[3])[None].expand(B, -1, -1, -1)
                   for s in srcs]
        else:
            pos = [sine_pos_table(s.shape[2], s.shape[3], self.hidden_dim, images.device)[None]
                   .expand(B, -1, -1, -1) for s in srcs]

        depth_logits, depth_tokens, weighted_depth, _ = self.depth_predictor(
            srcs, pos[1].reshape(B, -1, self.hidden_dim).to(dtype), gen)

        if self.query_free:
            queries = None
        elif self.use_dab:
            queries = torch.cat([self.tgt_embed.weight, self.refpoint_embed.weight], 1)
        else:
            queries = self.query_embed.weight
        if queries is not None and not train:
            queries = queries[:self.num_queries]
        hs, refs_in, inter_dims, enc_class, enc_coord, idx = self.depthaware_transformer(
            [s.permute(0, 2, 3, 1) for s in srcs], pos, queries, depth_tokens,
            self.bbox_embed, self.dim_embed_3d, gen, self.class_embed, train, proposal_idx)

        fy = calibs[:, 0, 0][:, None].float()  # focal (monodetr.py:242)
        outs = []
        for lvl in range(self.dec_layers):
            ref_unact = inverse_sigmoid(refs_in[lvl].float())
            tmp = self.bbox_embed[lvl](hs[lvl]).float()
            if ref_unact.shape[-1] == 6:
                tmp = tmp + ref_unact
            else:
                tmp = torch.cat([tmp[..., :2] + ref_unact, tmp[..., 2:]], -1)
            coord = torch.sigmoid(tmp)  # [B, Q, 6] cxcylrtb, normalised
            size3d = inter_dims[lvl]
            # depth_geo: f * h3d / h2d (monodetr.py:240-242)
            box2d_height = ((coord[:, :, 4] + coord[:, :, 5])
                            * img_sizes[:, 1:2].float()).clamp(min=1.0)
            depth_geo = size3d[:, :, 0] / box2d_height * fy
            depth_reg = self.depth_embed[lvl](hs[lvl]).float()
            # depth-map readout at the detached 3-D centre (monodetr.py:248-253)
            centers = ((coord[..., :2] - 0.5) * 2).detach()
            depth_map = grid_sample_bilinear(weighted_depth[..., None], centers,
                                             align_corners=True)[..., 0]
            depth_ave = (1.0 / (torch.sigmoid(depth_reg[:, :, 0]) + 1e-6) - 1.0
                         + depth_geo + depth_map) / 3
            outs.append({
                "pred_logits": self.class_embed[lvl](hs[lvl]).float(),
                "pred_boxes": coord,
                "pred_3d_dim": size3d,
                "pred_depth": torch.stack([depth_ave, depth_reg[:, :, 1]], -1),
                "pred_angle": self.angle_embed[lvl](hs[lvl]).float(),
            })
        out = dict(outs[-1])
        out["pred_depth_map_logits"] = depth_logits
        out["weighted_depth"] = weighted_depth
        out["aux_outputs"] = outs[:-1]
        if self.two_stage:
            out["enc_outputs"] = {"pred_logits": enc_class,
                                  "pred_boxes": torch.sigmoid(enc_coord)}
        if idx is not None:
            out["proposal_idx"] = idx
        return out


def _lecun_normal_(w, gen):
    """flax's default kernel init: truncated normal (+-2 sd) with variance
    1 / fan_in after truncation."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def _xavier_uniform_(w, gen):
    receptive = w[0, 0].numel()
    fan_out, fan_in = w.shape[0] * receptive, w.shape[1] * receptive
    a = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-a, a, generator=gen)


@torch.no_grad()
def init_params(model: MonoDETR, gen: torch.Generator):
    """Initialise every parameter from `gen` with the JAX model's
    initialisers: lecun-normal kernels and zero biases by default, xavier
    for the input projections, MHA in-projections and reference points,
    N(0, 1) embeddings, the MSDA zero kernels and offset-bias ring, and the
    focal-prior class bias and box-extent bias of the heads."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(m.weight, gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=gen)
    for m in model.modules():
        if isinstance(m, MultiheadAttention):
            _xavier_uniform_(m.in_proj_weight, gen)
            m.in_proj_bias.zero_()
        elif isinstance(m, MSDeformAttn):
            m.sampling_offsets.weight.zero_()
            m.init_offset_bias()
            m.attention_weights.weight.zero_()
            m.attention_weights.bias.zero_()
    for m in model.modules():
        if isinstance(m, LearnedPositionEmbedding):  # flax uniform(1.0)
            m.row_embed.weight.uniform_(0.0, 1.0, generator=gen)
            m.col_embed.weight.uniform_(0.0, 1.0, generator=gen)
    for seq in model.input_proj:
        _xavier_uniform_(seq[0].weight, gen)
    tr = model.depthaware_transformer
    tr.level_embed.normal_(0.0, 1.0, generator=gen)
    if hasattr(tr, "reference_points"):
        _xavier_uniform_(tr.reference_points.weight, gen)
    prior_prob = 0.01
    for i in range(len(model.class_embed)):
        model.class_embed[i].bias.fill_(-math.log((1 - prior_prob) / prior_prob))
        last = model.bbox_embed[i].layers[-1]
        if model.init_box:
            last.weight.zero_()
        # box extents start at sigmoid(-2) in head 0 (every head without
        # box refine); two_stage leaves every head's at 0 (monodetr.py:167-178)
        last.bias.zero_()
        if not model.two_stage and (i == 0 or not model.with_box_refine):
            last.bias[2:] = -2.0
    return model


REMAT_SCOPES = {False: (), "none": (), "backbone": ("backbone",), "encoder": ("encoder",),
                True: ("backbone", "encoder"), "all": ("backbone", "encoder")}


def check_remat(remat):
    """The scopes that the config's `remat` rematerialises
    (monodetr_tpu/models/monodetr.py:64-72): "backbone" checkpoints every
    trained Bottleneck, "encoder" every VisualEncoderLayer but for its
    sampled output; anything else raises the JAX model's ValueError."""
    if remat in REMAT_SCOPES:
        return REMAT_SCOPES[remat]
    raise ValueError(
        f"remat={remat!r}; expected one of "
        "False/'none', 'backbone', 'encoder', True/'all'")


def build_monodetr(cfg, seed=None) -> MonoDETR:
    """Model from the `model:` section of the config, on the CPU in f32;
    with `seed`, every parameter is initialised from torch.Generator(seed)."""
    model = MonoDETR(
        num_classes=cfg.get("num_classes", 3),
        num_queries=cfg.get("num_queries", 50),
        num_feature_levels=cfg.get("num_feature_levels", 4),
        group_num=cfg.get("group_num", 11),
        hidden_dim=cfg.get("hidden_dim", 256),
        backbone_name=cfg.get("backbone", "resnet50"),
        dilation=cfg.get("dilation", False),
        enc_layers=cfg.get("enc_layers", 3),
        dec_layers=cfg.get("dec_layers", 3),
        nheads=cfg.get("nheads", 8),
        dim_feedforward=cfg.get("dim_feedforward", 256),
        enc_n_points=cfg.get("enc_n_points", 4),
        dec_n_points=cfg.get("dec_n_points", 4),
        num_depth_bins=cfg.get("num_depth_bins", 80),
        depth_min=float(cfg.get("depth_min", 1e-3)),
        depth_max=float(cfg.get("depth_max", 60.0)),
        with_box_refine=cfg.get("with_box_refine", True),
        init_box=cfg.get("init_box", False),
        two_stage=cfg.get("two_stage", False),
        use_dab=cfg.get("use_dab", False),
        two_stage_dino=cfg.get("two_stage_dino", False),
        position_embedding=cfg.get("position_embedding", "sine"),
        msda_impl=cfg.get("msda_impl", "gather"),
        msda_window=cfg.get("msda_window", 8),
        dec_msda_impl=cfg.get("dec_msda_impl", "sep"),
        dropout=cfg.get("dropout", 0.1),
        remat=cfg.get("remat", False),
    )
    if seed is not None:
        init_params(model, torch.Generator().manual_seed(seed))
    return model.eval()


def compute_dtype(cfg):
    """The config's compute dtype (`dtype: bf16` or f32)."""
    return torch.bfloat16 if cfg.get("dtype", "float32") in ("bf16", "bfloat16") else torch.float32
