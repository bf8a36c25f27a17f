"""The backbone's epilogues: the elementwise passes between each bottleneck
block's cuDNN convolutions, one pass each (csrc/backbone.cu), and the
autograd.Function that runs a stage of blocks through them.

    bias_relu_(x, bias)                      x = max(x + bias[c], 0), in place
    tail(o3, idn, b3, bd=None, out=None)     max((o3 + b3[c]) + (idn + bd[c]), 0)
    accumulate_mask(ga, gb, x=None, out=None)  ga + gb where x > 0 (everywhere without x)

Tensors are [B, C, H, W] in channels_last memory (NHWC), all of one dtype,
bf16 or f32, C a multiple of 8; biases are f32 [C].  Arithmetic is f32,
in the order of PyTorch's passes (so f32 results are theirs bit for bit),
and each output is rounded once; a NaN passes (a) and (b) and keeps its
gradient in (d), as clamp_min and threshold_backward do.  `out` may be
an input.  On the CPU the plain versions (`*_plain`, the same
arithmetic in PyTorch) run; on CUDA the kernels run, or the wrapper raises
on what they do not take.  Every launch counts `backbone_epilogue`.

`bottleneck_stage(x, geometry, params)` runs torchvision Bottleneck blocks
(models/backbone.py) on folded weights: each block's convolutions are
torch.ops.aten.convolution without bias, as cuDNN runs them under
F.conv2d, and the passes between them are the three above.  Where a
gradient is wanted it is one autograd.Function over the blocks (_Stage):
it saves each block's input and its two inner activations and the last
block's output (what autograd saves for the plain blocks), and its
backward runs each block in reverse: the ReLU's threshold_backward on
the output's gradient, aten.convolution_backward for each convolution's
input and weight gradients, threshold_backward in place after conv3's and
conv2's input gradients, and (d), which adds the branch's and the skip's
gradient and applies the ReLU mask of the block before (a kernel of its
own for the lone ReLU mask was no faster than threshold_backward).
Weights enter the Function as inputs, so autograd outside it carries
their gradients through the fold.
"""

import torch
from torch.autograd.function import once_differentiable

from .. import _build
from ..utils.trace import count

COUNTER = "backbone_epilogue"
P = 8  # a block's params: w1, w2, w3, wd, b1, b2, b3, bd


def _nhwc(t):
    return t.contiguous(memory_format=torch.channels_last)


def bias_relu_plain(x, bias):
    return torch.relu(x.float() + bias.view(1, -1, 1, 1)).to(x.dtype)


def tail_plain(o3, idn, b3, bd=None):
    idn = idn.float() if bd is None else idn.float() + bd.view(1, -1, 1, 1)
    return torch.relu(o3.float() + b3.view(1, -1, 1, 1) + idn).to(o3.dtype)


def accumulate_mask_plain(ga, gb, x=None):
    s = (ga.float() + gb.float()).to(ga.dtype)
    return s if x is None else torch.ops.aten.threshold_backward(s, x, 0)


def _check(name, ts, biases):
    """(dtype code, numel, C) of the kernel's tensors `ts` and f32 `biases`;
    raises on what the kernels do not take."""
    x = ts[0]
    for t in ts + biases:
        if t.device != x.device or x.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device")
    for t in ts:
        if t.shape != x.shape or t.dtype != x.dtype or t.dim() != 4 \
                or not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name}: every tensor must be [B, C, H, W] of one shape and dtype "
                             f"in channels_last memory, got {[tuple(t.shape) for t in ts]}")
    C = x.shape[1]
    if C % 8:
        raise ValueError(f"{name}: C must be a multiple of 8, got {C}")
    for b in biases:
        if b.dtype != torch.float32 or b.shape != (C,) or not b.is_contiguous():
            raise ValueError(f"{name}: a bias must be f32 [{C}], got {b.dtype} {tuple(b.shape)}")
    return _build.dtype_code(x.dtype), x.numel(), C


def _launch(name, entry, ts, biases, out, plain):
    """Launch `entry` on inputs `ts` and then `biases` (None: no such
    input), writing `out` (a new tensor if None), or the plain version on
    the CPU."""
    x = ts[0]
    if out is None:
        out = torch.empty_like(x, memory_format=torch.channels_last)
    if x.device.type == "cpu":
        return out.copy_(plain())
    dtype, n, C = _check(name, [t for t in ts if t is not None] + [out],
                         [b for b in biases if b is not None])
    ptrs = [None if t is None else t.data_ptr() for t in ts + biases]
    _build.launch(entry, *ptrs, out.data_ptr(), dtype, n, C, _build.stream_of(x))
    count(COUNTER)
    return out


def bias_relu_(x, bias):
    """x = max(x + bias[c], 0) in place (x: a convolution's fresh output)."""
    return _launch("bias_relu_", "mdt_backbone_bias_relu", [x], [bias], x,
                   lambda: bias_relu_plain(x, bias))


def tail(o3, idn, b3, bd=None, out=None):
    """A block's last pass: max((o3 + b3[c]) + idn, 0), and where the
    downsample's convolution gives idn, its bias bd added to it."""
    return _launch("tail", "mdt_backbone_tail", [o3, idn], [b3, bd], out,
                   lambda: tail_plain(o3, idn, b3, bd))


def accumulate_mask(ga, gb, x=None, out=None):
    """A block's input gradient, the branch's ga plus the skip's gb, through
    the ReLU of the block that made the input x (none where x is None)."""
    return _launch("accumulate_mask", "mdt_backbone_accumulate_mask", [ga, gb, x], [], out,
                   lambda: accumulate_mask_plain(ga, gb, x))


def _conv(x, w, stride=(1, 1), padding=(0, 0), dilation=(1, 1)):
    return _nhwc(torch.ops.aten.convolution(x, w, None, stride, padding, dilation, False,
                                            (0, 0), 1))


def _relu_grad_(g, y):
    """g through a ReLU whose output was y, in place."""
    return torch.ops.aten.threshold_backward.grad_input(g, y, 0, grad_input=g)


def _conv_bwd(g, x, w, stride, padding, dilation, need_x, need_w):
    """(input gradient, weight gradient) of _conv, each None unless needed."""
    if not (need_x or need_w):
        return None, None
    gx, gw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, stride, padding, dilation, False, (0, 0), 1, (need_x, need_w, False))
    return (None if gx is None else _nhwc(gx)), gw


def block_forward(x, geometry, w1, w2, w3, wd, b1, b2, b3, bd):
    """One block without autograd: (output, (o1, o2))."""
    stride, padding, dilation, down = geometry
    o1 = bias_relu_(_conv(x, w1), b1)
    o2 = bias_relu_(_conv(o1, w2, stride, padding, dilation), b2)
    o3 = _conv(o2, w3)
    idn = x if wd is None else _conv(x, wd, down)
    return tail(o3, idn, b3, bd, out=o3), (o1, o2)


class _Stage(torch.autograd.Function):
    @staticmethod
    def forward(ctx, geometry, x, *params):
        ctx.geometry = geometry
        keep = []
        for i, geo in enumerate(geometry):
            y, (o1, o2) = block_forward(x, geo, *params[P * i:P * i + P])
            keep += [x, o1, o2]
            x = y
        weights = [w for i in range(len(geometry)) for w in params[P * i:P * i + 4]]
        ctx.save_for_backward(*keep, x, *weights)
        return x

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        geometry = ctx.geometry
        n = len(geometry)
        saved = ctx.saved_tensors
        y, weights = saved[3 * n], saved[3 * n + 1:]
        need = ctx.needs_input_grad  # (geometry, x, *params)
        grads = [None] * (P * n)
        g = torch.ops.aten.threshold_backward(_nhwc(gy.to(y.dtype)), y, 0)
        for i in reversed(range(n)):
            x, o1, o2 = saved[3 * i:3 * i + 3]
            w1, w2, w3, wd = weights[4 * i:4 * i + 4]
            stride, padding, dilation, down = geometry[i]
            need_w = need[2 + P * i:6 + P * i]
            need_x = i > 0 or need[1]
            g2, gw3 = _conv_bwd(g, o2, w3, (1, 1), (0, 0), (1, 1), True, need_w[2])
            _relu_grad_(g2, o2)
            g1, gw2 = _conv_bwd(g2, o1, w2, stride, padding, dilation, True, need_w[1])
            _relu_grad_(g1, o1)
            gxb, gw1 = _conv_bwd(g1, x, w1, (1, 1), (0, 0), (1, 1), need_x, need_w[0])
            gxs, gwd = g, None
            if wd is not None:
                gxs, gwd = _conv_bwd(g, x, wd, down, (0, 0), (1, 1), need_x, need_w[3])
            grads[P * i:P * i + 4] = gw1, gw2, gw3, gwd
            if need_x:
                g = accumulate_mask(gxb, gxs, x if i > 0 else None, out=gxb)
        return (None, g if need[1] else None, *grads)


def bottleneck_stage(x, geometry, params):
    """Blocks with `geometry` [(conv2's stride, padding, dilation, the
    downsample's stride or None)] and `params` [(w1, w2, w3, wd, b1, b2,
    b3, bd)] (folded weights in x's dtype, f32 biases; wd and bd None
    without a downsample) on x [B, C, H, W] (channels_last): the last
    block's output.  Through _Stage where autograd wants a gradient, else
    block by block."""
    flat = [t for p in params for t in p]
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in [x] + flat):
        return _Stage.apply(tuple(geometry), x, *flat)
    for geo, p in zip(geometry, params):
        x, _ = block_forward(x, geo, *p)
    return x


def stem(x, w, bias):
    """The stem: 7x7/2 convolution, 3x3/2 max pool, then (a).  Pooling
    first equals ReLU first bit for bit (max, the rounding and
    max(. + b, 0) are monotone, and the pool pads with -inf), on a quarter
    of the elements."""
    y = torch.nn.functional.max_pool2d(_conv(x, w, (2, 2), (3, 3)), 3, stride=2, padding=1)
    return bias_relu_(_nhwc(y), bias)
