"""ResNet-50 or ResNet-101 backbone with frozen batch norm, returning the
stride 8/16/32 features (monodetr_tpu/models/backbone.py); with `dilation`
the last stage keeps stride 16 and dilates its later blocks by 2
(torchvision's replace_stride_with_dilation, backbone.py:214-224).

Module names follow torchvision and the reference checkpoint
(`backbone.0.body.layer1.0.conv1.weight`, ...).  FrozenBatchNorm2d keeps the
reference's four buffers; the affine they define, scale = w / sqrt(rv +
eps), bias = b - rm * scale (reference backbone.py:62-64), is folded into
the preceding convolution's weight and bias in f32 at every call, as the
JAX package's FoldedConv does: one pass over the activations instead of
three.  The stem is a plain 7x7/2 convolution: the JAX
package's StemConv computes the same convolution by space-to-depth for the
TPU and takes the same [7, 7, 3, 64] weight.  Activations stay NCHW in
`channels_last` memory, which is NHWC in memory like the JAX layout.

The stem and layer1 never train (reference backbone.py:71-73): their
parameters have requires_grad=False and the graph is cut after layer1, as
the JAX package's stop_gradient does (backbone.py:229-237).  The FrozenBN
statistics are buffers, so folding them into a convolution differentiates
only the convolution's weight.

With `remat` (the config's `remat: backbone`, `True` or `all`) every
trained Bottleneck runs under torch.utils.checkpoint, as nn.remat(Bottleneck)
does (backbone.py:219): its activations are recomputed in the backward
from the block's input.  layer1 keeps no activations either way (its
output is detached).
"""

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

STAGE_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
BACKBONE_NUM_CHANNELS = (512, 1024, 2048)
BN_EPS = 1e-5


class FrozenBatchNorm2d(nn.Module):
    """Batch norm with fixed statistics and affine (never trained)."""

    def __init__(self, n):
        super().__init__()
        self.register_buffer("weight", torch.ones(n))
        self.register_buffer("bias", torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def affine(self):
        """(scale, bias) in f32."""
        scale = self.weight.float() * (self.running_var.float() + BN_EPS).rsqrt()
        return scale, self.bias.float() - self.running_mean.float() * scale


def conv_bn(conv, bn, x):
    """bn(conv(x)) as one convolution with the affine folded in."""
    scale, bias = bn.affine()
    w = (conv.weight.float() * scale.view(-1, 1, 1, 1)).to(x.dtype)
    return F.conv2d(x, w, bias.to(x.dtype), conv.stride, conv.padding, conv.dilation)


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 reduce -> 3x3 -> 1x1 expand (x4), residual."""

    def __init__(self, cin, width, stride=1, downsample=False, dilation=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(width * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, width * 4, 1, stride=stride, bias=False),
            FrozenBatchNorm2d(width * 4)) if downsample else None

    def forward(self, x):
        out = F.relu(conv_bn(self.conv1, self.bn1, x))
        out = F.relu(conv_bn(self.conv2, self.bn2, out))
        out = conv_bn(self.conv3, self.bn3, out)
        identity = x if self.downsample is None else conv_bn(*self.downsample, x)
        return F.relu(out + identity)


class ResNetBody(nn.Module):
    def __init__(self, name="resnet50", dilation=False, remat=False):
        super().__init__()
        if name not in STAGE_BLOCKS:
            raise ValueError(f"backbone {name!r} is not one of {tuple(STAGE_BLOCKS)}")
        self.name, self.remat = name, remat
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin, width = 64, 64
        for stage, n_blocks in enumerate(STAGE_BLOCKS[name]):
            stride, dil = (1 if stage == 0 else 2), 1
            if stage == 3 and dilation:  # the first block keeps dilation 1
                stride, dil = 1, 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(cin, width, stride if b == 0 else 1,
                                         downsample=(b == 0), dilation=1 if b == 0 else dil))
                cin = width * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            width *= 2
        for frozen in (self.conv1, self.layer1):
            frozen.requires_grad_(False)

    def _stage(self, layer, x):
        if not (self.remat and torch.is_grad_enabled()):
            return layer(x)
        for block in layer:
            x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False)
        return x

    def forward(self, x):
        x = F.relu(conv_bn(self.conv1, self.bn1, x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer1(x).detach()
        f8 = self._stage(self.layer2, x)
        f16 = self._stage(self.layer3, f8)
        return f8, f16, self._stage(self.layer4, f16)


class ResNetBackbone(nn.Module):
    """`body` as in the reference's IntermediateLayerGetter."""

    def __init__(self, name="resnet50", dilation=False, remat=False):
        super().__init__()
        self.body = ResNetBody(name, dilation, remat)

    def forward(self, images):
        """images [B, 3, H, W] -> (layer2, layer3, layer4) features,
        strides 8/16/32, channels 512/1024/2048."""
        return self.body(images)
