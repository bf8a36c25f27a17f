"""Data parallel over torch.distributed (monodetr_tpu/parallel/mesh.py).

One process per rank, started by torchrun (or any launcher that sets
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT); NCCL between
CUDA cards and gloo on the CPU.  The parameters are replicated (broadcast
from rank 0 at the start), each rank trains on its slice of the global
batch (the train loader's process_shard), and the step is the JAX SPMD
step's: the loss of the global batch.  Each rank's losses are its shares
of that loss (models/criterion.py: the box count and the dimension loss's
compensation weight are summed over ranks, the per-image means divided by
the rank count), the gradients are summed over ranks, and every rank then
takes the same optimizer step, so the parameters stay identical: the
step is train/train_step.py:make_train_step(..., dp=DataParallel()), the
counterpart of mesh.py:make_parallel_train_step.  Each rank draws its
dropout masks from its own generator (seed + rank).

Only the train loader is sharded; evaluation, checkpoints and result txts
belong to rank 0 (utils/misc.py:is_main_process).  The parallel eval step
decodes each rank's slice and gathers the detections of the whole batch
on every rank.
"""

import os

import torch
import torch.distributed as dist

from ..eval.decode import extract_dets_from_outputs


def rank_device(device):
    """This rank's device: a CUDA device given without an index is
    cuda:LOCAL_RANK."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def init_distributed(device="cuda", backend=None):
    """Join the process group described by the environment (torchrun's
    RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) over NCCL for a CUDA
    `device` and gloo for the CPU, unless `backend` says otherwise, and
    make rank_device(device) the current CUDA device.  Returns (rank,
    world)."""
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=int(os.environ.get("RANK", "0")),
                                world_size=int(os.environ.get("WORLD_SIZE", "1")))
    return dist.get_rank(), dist.get_world_size()


class DataParallel:
    """The ranks of the initialised default process group, as the
    criterion, the train step and the eval step use them."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()

    def sum(self, t):
        """The sum of `t` over ranks (a new tensor)."""
        t = t.clone()
        dist.all_reduce(t)
        return t

    def sum_grads(self, params):
        """Sum every parameter's gradient over ranks, in one all-reduce (a
        parameter without a gradient counts as zeros)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        for p, g in zip(params, flat.split([g.numel() for g in grads])):
            p.grad = g.view_as(p)

    def gather(self, t):
        """The ranks' `t` (one shape on every rank) concatenated along dim 0
        in rank order, on every rank.  One all-reduce of a zero buffer
        holding `t` in this rank's slot: gloo has no all_gather of CUDA
        tensors."""
        buf = t.new_zeros((self.world,) + tuple(t.shape))
        buf[self.rank] = t
        dist.all_reduce(buf)
        return buf.reshape((-1,) + tuple(t.shape[1:]))

    def shard(self, x):
        """This rank's rows of a global batch array (the rows the train
        loader's process_shard loads)."""
        n = x.shape[0] // self.world
        return x[self.rank * n:(self.rank + 1) * n]

    @torch.no_grad()
    def broadcast_(self, model):
        """Rank 0's parameters and buffers on every rank."""
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t, 0)


def make_parallel_eval_step(model, dp, topk=50):
    """eval_step(images, calibs, img_sizes) -> [world * B, topk, 37]: the
    top-k detections of this rank's slice of B images, gathered with the
    other ranks' in rank order, as extract_dets_from_outputs gives them
    for the whole batch."""

    @torch.no_grad()
    def eval_step(images, calibs, img_sizes):
        model.eval()
        return dp.gather(extract_dets_from_outputs(model(images, calibs, img_sizes), topk=topk))

    return eval_step
