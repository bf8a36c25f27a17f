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
(make_eval_step); the training step runs eagerly.
"""

import contextlib

import numpy as np
import torch

from ..ops.utils import held_constants
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
    that every dropout draws from (None: no dropout)."""
    loss_keys = []
    autocast = compute_dtype != torch.float32

    def train_step(batch, lr, gen=None):
        with span("train step"):
            model.train()
            device = batch["images"].device
            with span("forward"):
                with torch.autocast(device.type, dtype=compute_dtype, enabled=autocast):
                    out = model(batch["images"], batch["calibs"], batch["img_sizes"],
                                train=True, gen=gen)
            with span("criterion"):
                losses = criterion(out, {k: batch[k] for k in TARGET_KEYS}, train=True, dp=dp)
                total = criterion.total(losses)
            optimizer.zero_grad()
            with span("backward"):
                total.backward()
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
