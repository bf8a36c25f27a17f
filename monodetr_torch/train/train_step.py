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

On a CUDA card both steps replay CUDA graphs by one mechanism
(StepGraphs): the eval step one graph of its whole body (make_eval_step),
the training step graphs of the model's forward segments, their
backwards and the optimizer's update, with the criterion eager between
them (make_train_step).
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
    optimizer's update replay CUDA graphs (StepGraphs), while the
    criterion runs eagerly between the forward and the backward.  The step
    runs eagerly throughout on the CPU, with data parallel (`dp`), and
    with any of the model's remat scopes (the recompute sets the
    generator's state on the host, layers.checkpoint_with_gen)."""
    loss_keys = []
    autocast = compute_dtype != torch.float32
    remat = any(getattr(m, "remat", False) for m in model.modules())
    graphs = None if dp is not None or remat else StepGraphs(model, "train", optimizer.params)

    def train_step(batch, lr, gen=None):
        with span("train step"):
            model.train()
            device = batch["images"].device
            run = (graphs.begin((batch["images"], batch["calibs"], batch["img_sizes"]), gen)
                   if graphs and device.type == "cuda" else None)
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

    On a CUDA card the body (model.eval(), the forward, the top-k) is one
    CUDA graph for each key, with no autograd node (StepGraphs; `topk` is
    the step's own).  A replay copies the inputs into the graph's buffers
    and returns a clone of the graph's output, never the buffer itself, so
    an output held from one call is not overwritten by the next, and puts
    a model left in training mode back into eval mode, as an eager call
    leaves it.  On the CPU every call runs eagerly.

    Each call is the root span `eval step`.  A replay runs no Python of
    the model, so its root holds no inner span (`backbone`, `decoder`,
    ...) and no kernel launch counts: those appear on the eager and
    capture calls only."""
    from ..eval.decode import extract_dets_from_outputs

    def body(images, calibs, img_sizes):
        model.eval()
        return extract_dets_from_outputs(model(images, calibs, img_sizes), topk=topk)

    graphs = StepGraphs(model, "eval")

    @torch.no_grad()
    def eval_step(images, calibs, img_sizes):
        inputs = (images, calibs, img_sizes)
        with span("eval step"):
            if images.device.type != "cuda":
                return body(*inputs)
            with graphs.begin(inputs) as run:
                if run.eager:
                    return body(*inputs)
                if model.training:
                    model.eval()
                return run(None, body, inputs).clone()

    return eval_step


def _autocast_dtype():
    """CUDA autocast's dtype where it is on, else None."""
    return torch.get_autocast_dtype("cuda") if torch.is_autocast_enabled("cuda") else None


def _uncached_autocast():
    """The caller's CUDA autocast once more, nested, with its weight cache
    off: a capture under it records the casts of the f32 parameters as
    graph nodes, which read the parameters at every replay."""
    amp = _autocast_dtype()
    return (torch.autocast("cuda", dtype=amp, cache_enabled=False) if amp is not None
            else contextlib.nullcontext())


class StepGraphs:
    """A step's CUDA graphs by key on a CUDA card: the eval step's (`kind`
    "eval": its whole body, one graph) and the training step's ("train",
    with the optimizer's `params`: the model's forward segments, their
    backwards and the optimizer's update).

    The key (`key`) is the model inputs' shapes and dtypes and their
    device, autocast's state and dtype on CUDA, the matmul and cuDNN TF32
    switches, every module's `plain_ops` (the kernels or their plain
    versions) and the generator that the graphs draw from (None for eval).
    A key's first call runs eagerly: it fills the constant tables and
    picks the cuDNN and cuBLAS algorithms, and is the only warm-up, so a
    one-off caller never captures and a capture records only work already
    run once.  Its second call captures each graph in the order in which
    they run and replays it as it is captured; later calls replay them in
    that order (another order raises).  A parameter or buffer moved or
    replaced (its address changed: `state`) makes the next call of every
    key eager again, and the one after it capture anew; the model's
    parameters and buffers are those it had at the object's first call.

    Every capture runs on the object's own stream in thread-local mode
    (`capturing`; the prefetcher's thread may copy to the card meanwhile),
    after one empty_cache before the key's capture, and under a nested
    autocast with its weight cache off (_uncached_autocast), so weights
    loaded in place and a caller's autocast left and entered again are
    both seen.  All graphs of one object share one memory pool (a new one
    after a moved tensor); each key keeps the constant tables of its eager
    call and its capture (ops/utils.py:held_constants).  A call that
    captures counts `eval_graph_capture` or `train_graph_capture` (by
    `kind`) in its root span, a call that replays `eval_graph_replay` or
    `train_graph_replay`, however many graphs it replays.

    The training step's segments (utils/segments.py: the model's forward
    is cut at its spans, and the update is one more) are each one autograd
    node (TrainGraphSegment) with a graphed forward and a graphed
    backward, as torch.cuda.make_graphed_callables makes them over several
    callables; the criterion (matcher, LAP, losses and their backward)
    runs eagerly between the forward and the backward replays.  A replay
    copies a segment's inputs into the graph's buffers, but for an input
    that is an earlier graph's output (the same memory at every replay),
    and so for the gradients arriving at its backward.  A segment's
    backward graph computes the gradients of its inputs and of the trained
    parameters it reads; those go into one buffer per parameter (copied in
    by the first backward to reach the parameter, added by the later
    ones), which stays the parameter's .grad after the step and which the
    update's graph reads.  The step's generator is registered with every
    forward graph (CUDAGraph.register_generator_state): a replay draws
    what the eager step draws, at the same Philox offsets, and leaves the
    generator where the eager step leaves it; a capture draws nothing.

    A segment's graph replays inside its node's operator
    (`TrainGraphSegment`, in the backward `TrainGraphSegmentBackward`),
    inside the segment's span, so a profiler gives the forward's kernels
    to the span's range and the backward's through the node's sequence
    number.  A replayed training step's root holds the spans of the
    segments (`backbone`, `encoder MSDA`, `decoder`, ...), not those
    inside them, and counts no kernel launch but the criterion's."""

    def __init__(self, model, kind, params=()):
        self.model, self.kind, self.params = model, kind, params
        self.train = kind == "train"
        self.switches = None  # the modules that have `plain_ops`
        self.slots = None  # (the modules' tensor dicts, the names in them)
        self.entries = {}
        self.pool = self.stream = self.token = self.grads = None

    def key(self, inputs, gen=None):
        """The key of a call on the model inputs `inputs` that draws from
        `gen`."""
        if self.switches is None:
            self.switches = [m for m in self.model.modules() if hasattr(m, "plain_ops")]
        return (tuple((x.shape, x.dtype) for x in inputs), inputs[0].device, _autocast_dtype(),
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                tuple(m.plain_ops for m in self.switches), gen)

    def state(self):
        """The addresses of the model's parameters and buffers, read
        through their modules, so that a moved or a replaced tensor
        changes them."""
        if self.slots is None:
            slots = [(d, k) for m in self.model.modules() for d in (m._parameters, m._buffers)
                     for k, v in d.items() if v is not None]
            self.slots = tuple(zip(*slots)) or ((), ())
        return tuple(map(torch.Tensor.data_ptr, map(dict.__getitem__, *self.slots)))

    def begin(self, inputs, gen=None):
        """The call's entry, open for the step (`with`): eager, capture or
        replay."""
        key = self.key(inputs, gen)
        state = self.state()
        entry = self.entries.get(key)
        if entry is not None and entry.state != state:
            # a tensor moved: every graph reads stale addresses.  The next
            # capture takes a new pool: the old one keeps blocks that
            # outlive its graphs (the capture stream's cuBLAS workspaces),
            # and a pool whose graphs are all gone takes no other capture
            # while it holds a block
            self.entries.clear()
            self.grads = self.pool = entry = None
        if entry is None:
            entry = self.entries[key] = _KeyGraphs(self, key, state, gen)
            return entry
        entry.at = entry.cursor = 0
        if entry.mode == "eager":
            entry.mode = "capture"
            # the eager calls' cached blocks, which no capture can release
            torch.cuda.empty_cache()
            if self.stream is None:
                self.stream = torch.cuda.Stream()
                self.token = torch.zeros((), device=inputs[0].device, requires_grad=True)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            if self.grads is None:
                self.grads = [torch.zeros_like(p) for p in self.params]
        count(f"{self.kind}_graph_{entry.mode}")
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


class _KeyGraphs:
    """One key's graphs: the model's tensor addresses at its last eager
    call, the constant tables, the segments in the order of the step's
    calls, every graph in the order of its capture, and the storages of
    the graphs' outputs.  Open (`with`) for one call; the runner of its
    segments (the training step's routed to it, utils/segments.py)."""

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
        if self.graphs.train and not self.eager:
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
            raise RuntimeError(f"the {self.graphs.kind} step replayed {self.cursor} of its "
                               f"{len(self.order)} CUDA graphs")
        return False

    def is_fixed(self, x):
        return x.untyped_storage().data_ptr() in self.fixed

    def replay(self, graph):
        """Replays `graph`, which must be the next in the order of capture."""
        if self.mode == "capture":
            self.order.append(graph)
        elif self.cursor >= len(self.order) or self.order[self.cursor] is not graph:
            raise RuntimeError(f"the {self.graphs.kind} step's CUDA graphs replay out of their "
                               "order")
        self.cursor += 1
        graph.replay()

    def __call__(self, name, fn, args):
        """fn(*args) as the call's next segment, captured or replayed: the
        training step's as an autograd node, the eval step's without."""
        flat, spec = tree_flatten(args)
        if self.mode == "capture":
            seg = _Segment(self, name, fn, flat, spec)
            self.segments.append(seg)
        else:
            seg = self.segments[self.at] if self.at < len(self.segments) else None
            if seg is None or seg.name != name:
                raise RuntimeError(f"segment {name!r} was not captured at this point of the "
                                   f"{self.graphs.kind} step")
            self.at += 1
        tensors = [x for x in flat if isinstance(x, torch.Tensor)]
        with span(name) if name is not None else contextlib.nullcontext():
            if self.graphs.train:
                outs = TrainGraphSegment.apply(seg, self.graphs.token, *tensors)
            else:
                outs = seg.forward(tensors)
        leaves = list(seg.out_leaves)
        for i, t in zip(seg.out_slots, outs):
            leaves[i] = t
        return tree_unflatten(leaves, seg.out_spec)


class _Segment:
    """One segment's graphs (StepGraphs): its static inputs (each an
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
        graph = torch.cuda.CUDAGraph()
        if entry.gen is not None:
            graph.register_generator_state(entry.gen)
        with graphs.capturing(graph), torch.set_grad_enabled(graphs.train), routed(None), \
                _uncached_autocast():
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
