"""The backbone's epilogues (monodetr_torch/ops/backbone.py) on the CPU.

On the CPU the backbone runs its plain modules (models/backbone.py), the
code that the epilogue kernels are held to, and counts no launch; the
kernels themselves run only on a CUDA card (tests/test_torch_cuda.py).
What the kernels' callers do is held here through the wrappers' plain
versions, which the wrappers run for CPU tensors:

- the plain versions against PyTorch's own passes (the bias add, ReLU,
  residual add and threshold_backward), bit for bit in f32, NaN included;
- the stage Function (ops/backbone.py:_Stage) and the forward-only blocks
  against autograd over the plain Bottlenecks: in f32 to rounding (the
  same convolutions, the sums in the same order), on layer2 and on the
  dilated layer4, at batches 1 and 3; in f32 and bf16 bit for bit
  against autograd over the passes' plain versions (block_plain below);
  its backward leaves the arriving gradient as it was;
- the whole body with the fused path forced, remat on and off, against
  the plain body in f32;
- the pool-first stem against ReLU first, bit for bit in f32 and bf16;
- `MonoDETR.use_plain_ops` reaches the backbone, and the state-dict names
  are torchvision's.
"""

import pytest
import torch

from monodetr_torch import _build
from monodetr_torch.models.backbone import STAGE_BLOCKS, ResNetBody, conv_bn, fused_blocks
from monodetr_torch.models.monodetr import build_monodetr
from monodetr_torch.ops import backbone as ob
from monodetr_torch.utils import trace

torch.set_num_threads(2)
DTYPES = (torch.float32, torch.bfloat16)


def launches():
    return trace.counts().get(ob.COUNTER, 0)


def body_with_statistics(name="resnet50", dilation=False, remat=False, seed=0):
    """A body whose FrozenBN affines are not the identity (scales 0.25-0.75,
    biases of 0.1), so every bias and the ReLUs' masks matter."""
    body = ResNetBody(name, dilation, remat)
    gen = torch.Generator().manual_seed(seed)
    for m in body.modules():
        if hasattr(m, "running_var"):
            n = m.weight.numel()
            m.weight.copy_(torch.rand(n, generator=gen) * 0.5 + 0.25)
            m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
            m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
            m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return body


def channels_last(t):
    return t.contiguous(memory_format=torch.channels_last)


def block_plain(x, geometry, w1, w2, w3, wd, b1, b2, b3, bd):
    """ops/backbone.py:block_forward's plain version, differentiable: the
    same convolutions and the plain versions of (a) and (b).  Autograd over
    it rounds where the stage Function's backward does, in bf16 too."""
    stride, padding, dilation, down = geometry
    conv = torch.nn.functional.conv2d
    o1 = ob.bias_relu_plain(conv(x, w1), b1)
    o2 = ob.bias_relu_plain(conv(o1, w2, None, stride, padding, dilation), b2)
    idn = x if wd is None else conv(x, wd, None, down)
    return ob.tail_plain(conv(o2, w3), idn, b3, bd)


def stage_run(layer, x, gy, fused):
    """(output, input gradient, weight gradients) of one stage."""
    layer.zero_grad(set_to_none=True)
    x = x.detach().clone().requires_grad_()
    y = fused_blocks(list(layer), x) if fused else layer(x)
    y.backward(gy.to(y.dtype))
    return y.detach(), x.grad, [p.grad for p in layer.parameters()]


def test_ops_backbone_imports_and_runs_without_cuda():
    """The module imports and its wrappers run their plain versions on the
    CPU without loading the kernel library or counting a launch."""
    before, loaded = launches(), _build.library.cache_info().currsize
    x = channels_last(torch.randn(1, 8, 3, 5))
    b = torch.randn(8)
    ob.bias_relu_(x, b)
    ob.tail(x, x, b, b)
    ob.accumulate_mask(x, x, x)
    assert launches() == before and _build.library.cache_info().currsize == loaded


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_are_pytorchs_passes(dtype):
    """Each plain version (one rounding from f32) against PyTorch's own
    sequence: bit for bit in f32, and a NaN passes the forward and keeps
    its gradient as clamp_min and threshold_backward do."""
    gen = torch.Generator().manual_seed(1)
    x, y, z = (channels_last(torch.randn(2, 16, 5, 7, generator=gen)).to(dtype)
               for _ in range(3))
    x[0, 3, 1, 1] = y[1, 2, 0, 0] = float("nan")
    b3, bd = torch.randn(16, generator=gen), torch.randn(16, generator=gen)
    v = (1, -1, 1, 1)
    if dtype == torch.float32:  # PyTorch's f32 passes, as the plain modules run them
        want = [torch.relu(x + b3.view(v)), torch.relu((x + b3.view(v)) + (y + bd.view(v))),
                torch.relu((x + b3.view(v)) + y)]
    else:  # one rounding of the f32 sums
        want = [torch.relu(x.float() + b3.view(v)).to(dtype),
                torch.relu(x.float() + b3.view(v) + (y.float() + bd.view(v))).to(dtype),
                torch.relu(x.float() + b3.view(v) + y.float()).to(dtype)]
    got = [ob.bias_relu_plain(x, b3), ob.tail_plain(x, y, b3, bd), ob.tail_plain(x, y, b3)]
    got += [ob.accumulate_mask_plain(z, x, y), ob.accumulate_mask_plain(z, x)]
    want += [torch.where(y <= 0, 0.0, z + x).to(dtype), (z + x)]
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(torch.nan_to_num(g, 7.0),
                                                torch.nan_to_num(w, 7.0))
    assert torch.isnan(got[0][0, 3, 1, 1]) and torch.isnan(got[1][0, 3, 1, 1])
    assert got[3][1, 2, 0, 0] == (z + x)[1, 2, 0, 0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_pool_first_stem_equals_relu_first(dtype):
    """max_pool2d(relu(c + b)) equals relu(max_pool2d(c) + b) bit for bit:
    the bias add, its rounding and the ReLU are monotone, and the pool
    pads with -inf (every 3x3/2 window holds a real pixel)."""
    gen = torch.Generator().manual_seed(2)
    c = channels_last(torch.randn(2, 64, 19, 33, generator=gen)).to(dtype)
    b = torch.randn(64, generator=gen)
    pool = torch.nn.functional.max_pool2d
    first = pool(ob.bias_relu_plain(c, b), 3, stride=2, padding=1)
    assert torch.equal(ob.bias_relu_plain(pool(c, 3, stride=2, padding=1), b), first)


@pytest.mark.parametrize("dilation,layer", [(False, "layer2"), (True, "layer4")])
@pytest.mark.parametrize("batch,hw", [(1, (9, 13)), (3, (6, 5))])
def test_stage_function_equals_autograd_over_the_blocks(dilation, layer, batch, hw):
    """f32: the stage Function through the plain versions against autograd
    over the plain Bottlenecks: the output within 1e-6 of its largest
    entry, the input gradient and every weight gradient within 1e-5 (the
    CPU's convolution may add its bias inside, where cuDNN's adds it after;
    the sums are the same); the forward-only blocks (no gradient wanted)
    give the Function's output and count no launch."""
    body = body_with_statistics(dilation=dilation)
    blocks = getattr(body, layer)
    gen = torch.Generator().manual_seed(3)
    x = channels_last(torch.relu(torch.randn(batch, blocks[0].conv1.in_channels, *hw,
                                             generator=gen)))
    with torch.no_grad():
        gy = torch.randn(blocks(x).shape, generator=gen)
    before = launches()
    (y0, gx0, gw0), (y1, gx1, gw1) = (stage_run(blocks, x, gy, f) for f in (False, True))
    assert len(gw1) == len(gw0)
    for a, b, tol in [(y1, y0, 1e-6), (gx1, gx0, 1e-5)] + [(a, b, 1e-5) for a, b in zip(gw1, gw0)]:
        assert (a - b).abs().max() <= tol * b.abs().max()
    with torch.no_grad():
        assert torch.equal(fused_blocks(list(blocks), x), y1)
    assert launches() == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dilation,layer", [(False, "layer3"), (True, "layer4")])
def test_stage_function_equals_autograd_over_the_plain_versions(dtype, dilation, layer):
    """The stage Function against autograd over block_plain
    (the same convolutions and the plain versions of the passes, so the
    same roundings in bf16 too): output, input gradient and every weight
    gradient bit for bit.  (Against the plain Bottlenecks in bf16 a value
    one bf16 step from zero may fall on the other side of its ReLU, which
    moves a gradient entry by the whole of the gradient arriving there.)"""
    body = body_with_statistics(dilation=dilation, seed=4)
    blocks = getattr(body, layer)
    gen = torch.Generator().manual_seed(5)
    x = channels_last(torch.relu(torch.randn(2, blocks[0].conv1.in_channels, 11, 7,
                                             generator=gen))).to(dtype)
    with torch.no_grad():
        gy = torch.randn(blocks(x).shape, generator=gen)

    def twin(xi):
        for b in blocks:
            xi = block_plain(xi, b.geometry(), *b.folded(xi.dtype))
        return xi

    blocks.zero_grad(set_to_none=True)
    xi = x.detach().clone().requires_grad_()
    y = twin(xi)
    y.backward(gy.to(dtype))
    want = [y.detach(), xi.grad] + [p.grad for p in blocks.parameters()]
    got = stage_run(blocks, x, gy, True)
    got = [got[0], got[1]] + got[2]
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_stage_backward_leaves_the_arriving_gradient_as_it_was(dtype):
    """The stage Function's backward masks the gradient that arrives at its
    output into a tensor of its own (the ReLU masks after conv3's and
    conv2's input gradients are in place, on its own tensors): the
    arriving gradient, channels_last and of the stage's dtype, is
    unchanged."""
    body = body_with_statistics(seed=9)
    blocks = body.layer3
    gen = torch.Generator().manual_seed(10)
    x = channels_last(torch.relu(torch.randn(1, blocks[0].conv1.in_channels, 7, 5,
                                             generator=gen))).to(dtype).requires_grad_()
    y = fused_blocks(list(blocks), x)
    gy = channels_last(torch.randn(y.shape, generator=gen)).to(dtype)
    kept = gy.clone()
    assert bool((y == 0).any())
    y.backward(gy)
    assert torch.equal(gy, kept) and x.grad is not None


@pytest.mark.parametrize("remat", [False, True])
def test_body_with_the_fused_path_equals_the_plain_body(monkeypatch, remat):
    """The whole body (stem, frozen layer1, three trained stages; per
    block under checkpoint with remat) with the fused path forced through
    the plain versions, against the plain body, f32: the three features
    within 1e-6 of their largest entry, every weight gradient within 1e-5
    (as the stages above; f8's gradient also sums the loss's and layer3's
    in another order)."""
    body = body_with_statistics(dilation=True, remat=remat, seed=6)
    gen = torch.Generator().manual_seed(7)
    x = channels_last(torch.randn(2, 3, 64, 96, generator=gen))
    runs = []
    for fused in (False, True):
        monkeypatch.setattr(ResNetBody, "fused", lambda self, x, f=fused: f)
        body.zero_grad(set_to_none=True)
        feats = body(x)
        loss = sum((f * torch.linspace(-1, 1, f.numel()).view(f.shape)).sum() for f in feats)
        loss.backward()
        runs.append(([f.detach() for f in feats],
                     {n: p.grad for n, p in body.named_parameters() if p.grad is not None}))
    (f0, g0), (f1, g1) = runs
    assert all((a - b).abs().max() <= 1e-6 * b.abs().max() for a, b in zip(f1, f0))
    assert g1.keys() == g0.keys() and len(g0) == 3 * (4 + 6 + 3) + 3
    for n, g in g0.items():
        assert (g1[n] - g).abs().max() <= 1e-5 * g.abs().max(), n


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_backbone_runs_the_plain_modules(dtype):
    """On the CPU the body is the plain modules' sequence, bit for bit,
    and counts no launch."""
    body = body_with_statistics()
    gen = torch.Generator().manual_seed(8)
    x = channels_last(torch.randn(1, 3, 64, 96, generator=gen)).to(dtype)
    before = launches()
    with torch.no_grad():
        got = body(x)
        want = torch.nn.functional.max_pool2d(
            torch.relu(conv_bn(body.conv1, body.bn1, x)), 3, stride=2, padding=1)
        want = [body.layer2(body.layer1(want))]
        want += [body.layer3(want[0])]
        want += [body.layer4(want[1])]
    assert not body.fused(x) and launches() == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_use_plain_ops_reaches_the_backbone():
    """MonoDETR.use_plain_ops switches every module that has `plain_ops`,
    the backbone's body among them."""
    model = build_monodetr(dict(msda_impl="fused", msda_window=6, enc_layers=1, dec_layers=1,
                                dim_feedforward=32, num_queries=5, group_num=1), seed=0)
    body = model.backbone[0].body
    switches = [m for m in model.modules() if hasattr(m, "plain_ops")]
    assert body in switches and len(switches) > 1
    assert not any(m.plain_ops for m in switches)
    model.use_plain_ops(True)
    assert all(m.plain_ops for m in switches)
    model.use_plain_ops(False)
    assert not any(m.plain_ops for m in switches)


@pytest.mark.parametrize("name,dilation", [("resnet50", False), ("resnet50", True),
                                           ("resnet101", False)])
def test_state_dict_names_are_torchvisions(name, dilation):
    """The fused path adds no parameter or buffer: the state dict's names
    are torchvision's ResNet's (the reference checkpoint's)."""
    bn = ("weight", "bias", "running_mean", "running_var")
    want = ["conv1.weight"] + [f"bn1.{k}" for k in bn]
    for s, n in enumerate(STAGE_BLOCKS[name]):
        for i in range(n):
            p = f"layer{s + 1}.{i}."
            for j in (1, 2, 3):
                want += [f"{p}conv{j}.weight"] + [f"{p}bn{j}.{k}" for k in bn]
            if i == 0:
                want += [f"{p}downsample.0.weight"] + [f"{p}downsample.1.{k}" for k in bn]
    assert list(ResNetBody(name, dilation).state_dict()) == want
