"""The training step (monodetr_tpu/train/train_step.py:19-82): forward with
train=True -> Hungarian matching -> the 8 losses with aux layers ->
backward through the kernels -> the optimizer's update, in place.

Parameters and optimizer state stay f32; with compute dtype bf16 the
forward runs under torch.autocast, so the convolutions, the linears and
therefore the MSDA and attention kernels receive bf16 tensors, while the
places the JAX model keeps in f32 stay f32.  The step returns one stacked
loss vector in the JAX package's key order (sorted loss names, then
`loss_detr`, the weighted total), so a caller reads the losses from the
card with one copy.  With data parallel (`dp`, parallel/ddp.py) the step
is the JAX SPMD step's (monodetr_tpu/parallel/mesh.py:53-92): each rank
runs its slice of the global batch, its losses are its shares of the
global batch's (models/criterion.py), the gradients and the loss vector are
summed over ranks, and every rank takes the same optimizer step.

Host time (utils/trace.py): a step is the root span `train step`, whose
children are `forward` (the autocast model call, with the model's spans
inside), `criterion` (the matcher inside), `backward` (the call that
returns once the card has the backward's launches queued) and `optimizer`;
zero_grad, data parallel's gradient sum and the loss stacking are the
root's own time.  `batch_to_device` and the eval step (`eval step`: the
eval forward and the top-k) are roots of their own.

On a CUDA card the eval step replays a CUDA graph of its body
(make_eval_step), and the training step replays CUDA graphs of the
model's forward segments, their backwards and the optimizer's update,
with the criterion eager between them (make_train_step, TrainGraphs).
"""

import contextlib

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..ops.utils import held_constants
from ..utils.segments import routed
from ..utils.trace import count, span

TARGET_KEYS = ("labels", "boxes", "boxes_3d", "depth", "size_3d", "heading_bin",
               "heading_res", "mask")
BATCH_KEYS = ("images", "calibs", "img_sizes") + TARGET_KEYS


def batch_to_device(batch, device, keys=BATCH_KEYS):
    """The loader's numpy batch (its `keys`) as tensors on `device` (mask as
    bool).

    On a CUDA device each array is copied into pinned host memory and from
    there to the card by a copy queued on the current stream, without
    waiting for the card: the host may free or reuse the pinned buffer
    only after that copy ends (the caching host allocator records the
    copy's event).  A buffer that cannot be pinned raises.  On the CPU the
    arrays are taken as they are (a CPU-only build cannot pin)."""
    device = torch.device(device)
    out = {}
    with span("batch_to_device"):
        for k in keys:
            t = torch.from_numpy(np.ascontiguousarray(batch[k], bool if k == "mask" else None))
            if device.type == "cuda":
                out[k] = t.pin_memory().to(device, non_blocking=True)
            else:
                out[k] = t.to(device)
    return out


def make_train_step(model, criterion, optimizer, compute_dtype=torch.float32, dp=None):
    """Returns train_step(batch, lr, gen) -> LossVector.

    batch: tensors on the model's device (batch_to_device; with `dp` this
    rank's slice); lr: a float; gen: the torch.Generator on that device
    that every dropout draws from (None: no dropout).

    On a CUDA card the model's forward segments, their backwards and the
    optimizer's update replay CUDA graphs (TrainGraphs), while the
    criterion runs eagerly between the forward and the backward.  The step
    runs eagerly throughout on the CPU, with data parallel (`dp`), and
    with any of the model's remat scopes (the recompute sets the
    generator's state on the host, layers.checkpoint_with_gen)."""
    loss_keys = []
    autocast = compute_dtype != torch.float32
    remat = any(getattr(m, "remat", False) for m in model.modules())
    graphs = None if dp is not None or remat else TrainGraphs(model, optimizer)

    def train_step(batch, lr, gen=None):
        with span("train step"):
            model.train()
            device = batch["images"].device
            run = graphs.begin(batch, gen) if graphs and device.type == "cuda" else None
            with run or contextlib.nullcontext():
                with span("forward"):
                    with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
                        out = model(batch["images"], batch["calibs"], batch["img_sizes"],
                                    train=True, gen=gen)
                with span("criterion"):
                    losses = criterion(out, {k: batch[k] for k in TARGET_KEYS}, train=True,
                                       dp=dp)
                    total = criterion.total(losses)
                if run is None or run.eager:
                    optimizer.zero_grad()
                with span("backward"):
                    total.backward()
                if run is not None and not run.eager:
                    graphs.hand_over_grads()
                if dp is not None:
                    dp.sum_grads(optimizer.params)
                with span("optimizer"):
                    optimizer.step(lr)
            keys = sorted(losses)
            if not loss_keys:
                loss_keys.extend(keys + ["loss_detr"])
            stacked = torch.stack([losses[k].detach().float() for k in keys] + [total.detach()])
            return LossVector(tuple(loss_keys), stacked if dp is None else dp.sum(stacked))

    return train_step


def make_eval_step(model, topk=50, threshold=0.2):
    """Returns eval_step(images, calibs, img_sizes) -> detections [B, topk,
    37] (eval/decode.py:extract_dets_from_outputs), the eval forward and
    the top-k under no_grad (monodetr_tpu/train/train_step.py:85-97; as
    there, `threshold` is the decode's, applied on the host).

    On a CUDA card the body (model.eval(), the forward, the top-k) becomes
    a CUDA graph, one for each key: the inputs' shapes and dtypes, their
    device, autocast's state and dtype on CUDA, and the TF32 switches of
    matmul and cuDNN (`topk` is the step's own).  A key's first call runs
    eagerly: it fills the constant tables and picks the cuDNN and cuBLAS
    algorithms.  Its second call captures the body and replays it, and
    later calls replay.  A one-off caller therefore never captures, and a
    capture records only work already run once.  A replay copies the
    inputs into the graph's own buffers and returns a clone of the graph's
    output, never the buffer itself, so an output held from one call is
    not overwritten by the next.  The capture runs under a nested
    torch.autocast with its weight cache off: the casts of the f32
    parameters are nodes of the graph, read from the parameters at every
    replay, so weights loaded in place and a caller's autocast left and
    entered again are both seen.  A parameter or buffer moved or replaced
    (its address changed) makes the next call of every key eager again,
    and the one after it re-capture; the model's parameters and buffers
    are those it had at the step's first call on the card.  All the step's graphs share
    one memory pool, and each keeps the constant tables of its capture
    (ops/utils.py:held_constants).  On the CPU every call runs eagerly.

    Each call is the root span `eval step`; a capture counts
    `eval_graph_capture` in it, a replay `eval_graph_replay`
    (utils/trace.py).  A replay runs no Python of the model, so its root
    holds no inner span (`backbone`, `decoder`, ...) and no kernel launch
    counts: those appear on the eager and capture calls only."""
    from ..eval.decode import extract_dets_from_outputs

    def body(images, calibs, img_sizes):
        model.eval()
        return extract_dets_from_outputs(model(images, calibs, img_sizes), topk=topk)

    graphs = EvalGraphs(model, body)

    @torch.no_grad()
    def eval_step(images, calibs, img_sizes):
        with span("eval step"):
            if images.device.type != "cuda":
                return body(images, calibs, img_sizes)
            return graphs(images, calibs, img_sizes)

    return eval_step


class _Entry:
    """One key's state: the model's tensor addresses at its last eager
    call, the constant tables that call used, and, once captured, the
    graph, its input buffers and its output."""

    __slots__ = ("state", "tables", "graph", "inputs", "out")

    def __init__(self, state):
        self.state, self.tables, self.graph = state, {}, None


class EvalGraphs:
    """The eval step's CUDA graphs by key (make_eval_step's policy).
    `body(images, calibs, img_sizes)` is the step's work, run eagerly or
    captured."""

    def __init__(self, model, body):
        self.model, self.body = model, body
        self.slots = None  # (the modules' tensor dicts, the names in them)
        self.entries = {}
        self.pool = None

    def state(self):
        """The addresses of the model's parameters and buffers, read
        through their modules, so that a moved or a replaced tensor
        changes them."""
        if self.slots is None:
            slots = [(d, k) for m in self.model.modules() for d in (m._parameters, m._buffers)
                     for k, v in d.items() if v is not None]
            self.slots = tuple(zip(*slots)) or ((), ())
        return tuple(map(torch.Tensor.data_ptr, map(dict.__getitem__, *self.slots)))

    def __call__(self, images, calibs, img_sizes):
        inputs = (images, calibs, img_sizes)
        amp = torch.get_autocast_dtype("cuda") if torch.is_autocast_enabled("cuda") else None
        key = (images.shape, images.dtype, calibs.shape, calibs.dtype, img_sizes.shape,
               img_sizes.dtype, images.device, amp, torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        state = self.state()
        entry = self.entries.get(key)
        if entry is None or entry.state != state:
            if entry is not None:  # a tensor moved: every graph reads stale addresses
                self.entries.clear()
            entry = self.entries[key] = _Entry(state)
            with held_constants(entry.tables):
                return self.body(*inputs)
        if entry.graph is None:
            self.capture(entry, inputs, amp)
            count("eval_graph_capture")
        else:
            for buf, x in zip(entry.inputs, inputs):
                buf.copy_(x)
            if self.model.training:  # left in eval mode, as an eager call leaves it
                self.model.eval()
            count("eval_graph_replay")
        entry.graph.replay()
        return entry.out.clone()

    def capture(self, entry, inputs, amp):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        entry.inputs = tuple(x.clone(memory_format=torch.contiguous_format) for x in inputs)
        graph = torch.cuda.CUDAGraph()
        cast = (torch.autocast("cuda", dtype=amp, cache_enabled=False) if amp is not None
                else contextlib.nullcontext())
        # thread_local: the prefetcher's thread may copy to the card meanwhile
        with held_constants(entry.tables), torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"), cast:
            entry.out = self.body(*entry.inputs)
        entry.graph = graph


class TrainGraphs:
    """The training step's CUDA graphs by key (make_train_step's policy on a
    CUDA card).

    The key is the model inputs' shapes and dtypes and their device,
    autocast's state and dtype on CUDA, the matmul and cuDNN TF32 switches
    and every module's `plain_ops` (the kernels or their plain versions);
    a key's graphs draw from one generator, and a call with another (or
    with none) is the key's first call again.  A key's first call runs
    eagerly: it fills the constant tables and picks the cuDNN and cuBLAS
    algorithms, and is the only warm-up.  Its second call captures, in the
    order in which they run, each forward segment's graph
    (utils/segments.py: the model's forward is cut at its spans), each
    segment's backward graph as the autograd engine calls it, and the
    optimizer's update, replaying each as it is captured; later calls
    replay them in that order (another order raises).  A
    parameter or buffer moved or replaced (its address changed) makes the
    next call of every key eager again, and the one after it capture anew
    (EvalGraphs.state's rule).

    Each segment is one autograd node (TrainGraphSegment), with a graphed
    forward and a graphed backward, as torch.cuda.make_graphed_callables
    makes them over several callables.  A replay copies a segment's inputs
    into the graph's buffers, but for an input that is an earlier graph's
    output (the same memory at every replay), and so for the gradients
    arriving at its backward.  A segment's backward graph computes the
    gradients of its inputs and of the trained parameters it reads; those
    go into one buffer per parameter (copied in by the first backward to
    reach the parameter, added by the later ones), which stays the
    parameter's .grad after the step and which the update's graph reads.
    The criterion (matcher, LAP, losses and their backward) runs eagerly
    between the forward and the backward replays.

    The step's generator is registered with every forward graph
    (CUDAGraph.register_generator_state): a replay draws what the eager
    step draws, at the same Philox offsets, and leaves the generator where
    the eager step leaves it; a capture draws nothing.  The captures run
    under a nested autocast with its weight cache off, so the casts of the
    f32 parameters are graph nodes.  All graphs of one step object share
    one memory pool; each key keeps the constant tables of its capture.

    A graph replays inside its node's operator (`TrainGraphSegment`, in
    the backward `TrainGraphSegmentBackward`), inside the segment's span,
    so a profiler gives the forward's kernels to the span's range and the
    backward's through the node's sequence number.  A replay runs no
    Python of the model: a replayed step's root holds the spans of the
    segments (`backbone`, `encoder MSDA`, `decoder`, ...), not those inside
    them, and counts no kernel launch but the criterion's."""

    def __init__(self, model, optimizer):
        self.model, self.params = model, optimizer.params
        self.switches = [m for m in model.modules() if hasattr(m, "plain_ops")]
        self.slots = None
        self.entries = {}
        self.pool = self.stream = self.token = self.grads = None

    state = EvalGraphs.state

    def begin(self, batch, gen):
        """The call's entry, open for the step (`with`): eager, capture or
        replay."""
        images, calibs, sizes = batch["images"], batch["calibs"], batch["img_sizes"]
        amp = torch.get_autocast_dtype("cuda") if torch.is_autocast_enabled("cuda") else None
        key = (images.shape, images.dtype, calibs.shape, calibs.dtype, sizes.shape, sizes.dtype,
               images.device, amp, torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32, tuple(m.plain_ops for m in self.switches))
        state = self.state()
        entry = self.entries.get(key)
        if entry is not None and entry.state != state:
            # a tensor moved: every graph reads stale addresses
            self.entries.clear()
            self.grads = entry = None
        if entry is None or entry.gen is not gen:
            entry = self.entries[key] = _TrainEntry(self, key, state, gen)
            return entry
        entry.at = entry.cursor = 0
        if entry.mode == "eager":
            entry.mode = "capture"
            # the eager calls' cached blocks, which no capture can release
            torch.cuda.empty_cache()
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
                self.stream = torch.cuda.Stream()
                self.token = torch.zeros((), device=images.device, requires_grad=True)
            if self.grads is None:
                self.grads = [torch.zeros_like(p) for p in self.params]
            count("train_graph_capture")
        else:
            count("train_graph_replay")
        return entry

    def hand_over_grads(self):
        """After a graphed backward: each parameter's .grad is its buffer."""
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:
                p.grad = g

    @contextlib.contextmanager
    def capturing(self, graph):
        """Captures the block's work into `graph` on the graphs' own stream
        (thread-local mode: the prefetcher's thread may copy meanwhile)."""
        here = torch.cuda.current_stream()
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(self.pool, capture_error_mode="thread_local")
            try:
                yield
            finally:
                graph.capture_end()
        here.wait_stream(self.stream)


class _TrainEntry:
    """One key's graphs: the model's tensor addresses at its last eager
    call, the constant tables, the segments in the order of the step's
    calls, every graph in the order of its capture, and the storages of
    the graphs' outputs.  Open (`with`) for one step; the routed runner of
    its segments (utils/segments.py)."""

    def __init__(self, graphs, key, state, gen):
        self.graphs, self.key, self.state, self.gen = graphs, key, state, gen
        self.tables, self.segments, self.order = {}, [], []
        self.fixed = set()  # storages of the graphs' outputs
        self.written = set()  # parameters whose buffer a captured backward writes
        self.mode = "eager"
        self.at = self.cursor = 0
        self.stack = None

    @property
    def eager(self):
        return self.mode == "eager"

    def __enter__(self):
        self.stack = contextlib.ExitStack()
        self.stack.enter_context(held_constants(self.tables))
        if not self.eager:
            self.stack.enter_context(routed(self))
        return self

    def __exit__(self, exc_type, exc, tb):
        self.stack.close()
        if exc_type is not None:
            if self.mode == "capture":  # a half-made capture is never replayed
                self.graphs.entries.pop(self.key, None)
        elif self.mode == "capture":
            self.mode = "replay"
        elif self.mode == "replay" and self.cursor != len(self.order):
            raise RuntimeError(f"the training step replayed {self.cursor} of its "
                               f"{len(self.order)} CUDA graphs")
        return False

    def is_fixed(self, x):
        return x.untyped_storage().data_ptr() in self.fixed

    def replay(self, graph):
        """Replays `graph`, which must be the next in the order of capture."""
        if self.mode == "capture":
            self.order.append(graph)
        elif self.cursor >= len(self.order) or self.order[self.cursor] is not graph:
            raise RuntimeError("the training step's CUDA graphs replay out of their order")
        self.cursor += 1
        graph.replay()

    def __call__(self, name, fn, args):
        flat, spec = tree_flatten(args)
        if self.mode == "capture":
            seg = _Segment(self, name, fn, flat, spec)
            self.segments.append(seg)
        else:
            seg = self.segments[self.at] if self.at < len(self.segments) else None
            if seg is None or seg.name != name:
                raise RuntimeError(f"segment {name!r} was not captured at this point of the "
                                   "training step")
            self.at += 1
        tensors = [x for x in flat if isinstance(x, torch.Tensor)]
        with span(name) if name is not None else contextlib.nullcontext():
            outs = TrainGraphSegment.apply(seg, self.graphs.token, *tensors)
        leaves = list(seg.out_leaves)
        for i, t in zip(seg.out_slots, outs):
            leaves[i] = t
        return tree_unflatten(leaves, seg.out_spec)


class _Segment:
    """One segment's graphs (TrainGraphs): its static inputs (each an
    earlier graph's output, or a buffer of its own that a replay copies
    into), its forward graph and static outputs, and its backward graph
    with the static gradients of its outputs (each arriving from another
    graph's buffer, or copied into one of its own) and of its inputs."""

    def __init__(self, entry, name, fn, flat, spec):
        self.entry, self.name, self.fn = entry, name, fn
        self.in_leaves, self.in_spec = flat, spec
        self.fwd = self.bwd = None

    def forward(self, inputs):
        if self.fwd is None:
            self.capture_forward(inputs)
        else:
            for buf, x, alias in zip(self.static_in, inputs, self.aliased):
                if not alias:
                    buf.copy_(x)
                elif buf.data_ptr() != x.data_ptr():
                    raise RuntimeError(f"an input of segment {self.name!r} moved")
            self.entry.replay(self.fwd)
        return tuple(o.detach() for o in self.static_out)

    def capture_forward(self, inputs):
        entry, graphs = self.entry, self.entry.graphs
        self.aliased = [entry.is_fixed(x) for x in inputs]
        self.static_in = [(x.detach() if a else x.detach().clone()).requires_grad_(x.requires_grad)
                          for x, a in zip(inputs, self.aliased)]
        it = iter(self.static_in)
        args = tree_unflatten([next(it) if isinstance(v, torch.Tensor) else v
                               for v in self.in_leaves], self.in_spec)
        amp = torch.get_autocast_dtype("cuda") if torch.is_autocast_enabled("cuda") else None
        cast = (torch.autocast("cuda", dtype=amp, cache_enabled=False) if amp is not None
                else contextlib.nullcontext())
        graph = torch.cuda.CUDAGraph()
        if entry.gen is not None:
            graph.register_generator_state(entry.gen)
        with graphs.capturing(graph), torch.enable_grad(), routed(None), cast:
            out = self.fn(*args)
        self.fn = self.in_leaves = None
        self.out_leaves, self.out_spec = tree_flatten(out)
        self.out_slots = [i for i, v in enumerate(self.out_leaves) if isinstance(v, torch.Tensor)]
        self.static_out = [self.out_leaves[i] for i in self.out_slots]
        self.diff = [o.requires_grad for o in self.static_out]
        entry.fixed.update(o.untyped_storage().data_ptr() for o in self.static_out)
        self.fwd = graph
        entry.replay(graph)

    def backward(self, grads):
        if self.bwd is None:
            self.capture_backward(grads)
        else:
            if tuple(g is not None for g in grads) != self.grad_mask:
                raise RuntimeError(f"segment {self.name!r} got other gradients than at its "
                                   "capture")
            for buf, g, alias in zip(self.static_gout, [g for g in grads if g is not None],
                                     self.gout_aliased):
                if not alias:
                    buf.copy_(g)
                elif buf.data_ptr() != g.data_ptr():
                    raise RuntimeError(f"a gradient arriving at segment {self.name!r} moved")
            if self.bwd is not False:
                self.entry.replay(self.bwd)
        return tuple(g.detach() if g is not None else None for g in self.static_gin)

    def capture_backward(self, grads):
        entry, graphs = self.entry, self.entry.graphs
        self.grad_mask = tuple(g is not None for g in grads)
        outs = [o for o, g in zip(self.static_out, grads) if g is not None]
        arriving = [g for g in grads if g is not None]
        self.gout_aliased = [entry.is_fixed(g) for g in arriving]
        self.static_gout = [g.detach() if a else g.detach().clone()
                            for g, a in zip(arriving, self.gout_aliased)]
        ins = [s for s in self.static_in if s.requires_grad]
        if not outs:
            self.bwd, self.static_gin = False, (None,) * len(self.static_in)
            return
        graph = torch.cuda.CUDAGraph()
        with held_constants(entry.tables), graphs.capturing(graph):
            got = torch.autograd.grad(outs, ins + graphs.params, self.static_gout,
                                      allow_unused=True)
            first, later = ([], []), ([], [])
            for i, g in enumerate(got[len(ins):]):
                if g is not None:
                    pair = later if i in entry.written else first
                    pair[0].append(graphs.grads[i])
                    pair[1].append(g)
                    entry.written.add(i)
            if first[0]:
                torch._foreach_copy_(*first)
            if later[0]:
                torch._foreach_add_(*later)
        it = iter(got[:len(ins)])
        self.static_gin = tuple(next(it) if s.requires_grad else None for s in self.static_in)
        entry.fixed.update(g.untyped_storage().data_ptr() for g in self.static_gin
                           if g is not None)
        self.bwd = graph
        entry.replay(graph)


class TrainGraphSegment(torch.autograd.Function):
    """One segment of the training step's graphs as one autograd node: the
    forward replays the segment's forward graph (capturing it first), the
    backward its backward graph.  `token`, a leaf that requires grad, makes
    every segment's outputs differentiable: the parameters a segment reads
    are not its inputs, since their gradients stay in the graphs' buffers."""

    @staticmethod
    def forward(ctx, seg, token, *inputs):
        ctx.seg = seg
        ctx.set_materialize_grads(False)
        outs = seg.forward(inputs)
        ctx.mark_non_differentiable(*(o for o, d in zip(outs, seg.diff) if not d))
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None, None) + ctx.seg.backward(grads)


class LossVector:
    """Named view of the stacked loss vector; reading a value copies the
    whole vector to the host once."""

    def __init__(self, keys, values):
        self.keys_ = keys
        self.values = values
        self._host = None

    def _pull(self):
        if self._host is None:
            self._host = self.values.cpu().numpy()
        return self._host

    def items(self):
        host = self._pull()
        return [(k, host[i]) for i, k in enumerate(self.keys_)]

    def as_dict(self):
        return dict(self.items())
