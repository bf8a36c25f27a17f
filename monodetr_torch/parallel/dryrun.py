"""Data-parallel runs over several processes: the port's twin of
__graft_entry__.py:dryrun_multichip, and the comparison of a data-parallel
step with one process's step on the whole batch.

    python -m monodetr_torch.parallel.dryrun 2

dryrun_multichip(n) runs compare_with_one_process over n gloo processes on
the CPU (tiny 64x128 images, one image a rank, the shipped model's widths
and depths), checks that the loss is finite and that every rank's
parameters equal rank 0's bit for bit, and prints one line.

compare_with_one_process(n, ...) starts n ranks that each take one f32
train step without dropout on their slice of a seeded global batch (rank
1 onwards from other initial weights, which the broadcast from rank 0
replaces), after their shares of each loss term and the parallel eval
step's detections; rank 0 then runs the same weights in one process on
the whole batch and returns the differences (step_report).  On a CUDA
device every rank runs the kernels (several ranks may share one card over
gloo).

The processes run under a time limit and are killed when one of them
fails or the limit passes (run_ranks).
"""

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the kernels of the step whose launches the report gives (utils/trace.py's counters)
COUNTED = ("msda_enc_fused", "msda_enc_fused_bwd", "msda_sep", "msda_sep_bwd", "attention_fwd",
           "attention_bwd", "lap")


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argv, n, timeout, env=None, cwd=REPO):
    """Run `argv` in n processes with torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR=localhost and a free MASTER_PORT);
    returns each rank's (exit code, stdout + stderr).  Every process is
    killed when one exits non-zero or `timeout` seconds pass; a timeout
    raises TimeoutError."""
    port = str(free_port())
    procs, logs = [], []
    try:
        for rank in range(n):
            log = tempfile.TemporaryFile(mode="w+")
            rank_env = dict(os.environ, **(env or {}), RANK=str(rank), WORLD_SIZE=str(n),
                            LOCAL_RANK=str(rank), MASTER_ADDR="localhost", MASTER_PORT=port)
            procs.append(subprocess.Popen(argv, cwd=cwd, env=rank_env, stdout=log,
                                          stderr=subprocess.STDOUT))
            logs.append(log)
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{argv}: {n} ranks still running after {timeout} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    out = []
    for p, log in zip(procs, logs):
        log.seek(0)
        out.append((p.returncode, log.read()))
        log.close()
    return out


def dryrun_multichip(n_devices, timeout=600):
    """One DP train step of the shipped model's widths and depths over
    n_devices gloo processes on the CPU, one 64x128 image a rank
    (compare_with_one_process); raises RuntimeError unless every rank runs,
    the loss is finite and the parameters are identical on every rank."""
    r = compare_with_one_process(n_devices, "cpu", batch=1, enc_layers=3, dec_layers=3,
                                 timeout=timeout)
    total = r["losses"]["loss_detr"]
    if r["n_equal"] != n_devices or not math.isfinite(total):
        raise RuntimeError(f"dryrun_multichip({n_devices}): loss_detr {total}, "
                           f"{r['n_equal']} of {n_devices} ranks hold rank 0's parameters")
    print(f"dryrun_multichip({n_devices}): one DP train step OK, loss_detr={total:.3f}, "
          f"parameters identical on all {n_devices} ranks", flush=True)


def compare_with_one_process(n, device="cpu", backend=None, height=64, width=128, batch=2,
                             enc_layers=1, dec_layers=2, timeout=600):
    """step_report of n ranks with `batch` images each against one
    process on all n * batch (module docstring); raises RuntimeError when
    a rank fails."""
    if device.startswith("cuda"):
        from .._build import build

        build()  # once here, not in every rank
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "report.json")
        argv = [sys.executable, "-m", "monodetr_torch.parallel.dryrun", "--compare",
                "--device", device, "--height", str(height), "--width", str(width),
                "--batch", str(batch), "--enc-layers", str(enc_layers),
                "--dec-layers", str(dec_layers), "--report", report]
        if backend:
            argv += ["--backend", backend]
        results = run_ranks(argv, n, timeout, env={"OMP_NUM_THREADS": "1"})
        for rank, (rc, out) in enumerate(results):
            if rc != 0:
                raise RuntimeError(f"rank {rank} of {n} exited {rc}: {out[-3000:]}")
        with open(report) as f:
            return json.load(f)


def adamw_first_move(grad, lr, eps=1e-8, b2=0.999):
    """How far the first step of train/optimizer.py:RefAdamW moves a
    parameter for a gradient, weight decay aside (float64):
    lr * sqrt(1 - b2) / (1 - b1) * m / (sqrt(v) + eps) with m = (1 - b1) g
    and v = (1 - b2) g^2 is lr * g / (|g| + eps / sqrt(1 - b2))."""
    g = grad.double()
    return lr * g / (g.abs() + eps / (1 - b2) ** 0.5)


def step_report(model, single, dp_losses, single_losses, lr):
    """The data-parallel step against one process's, after both from the
    same weights: the loss vectors; the worst gradient error in the train
    step's measure, max |a - b| / (1e-3 max|b| + 1e-6) per tensor; and
    the parameters.  AdamW's first step divides a gradient by its own size
    (a sign step but for eps), so where the two runs' sums of a gradient
    differ in rounding, a parameter may move by up to 2 lr apart.  Each
    element's difference is therefore held to the one its two gradients
    imply, |(p_dp - p_1) - (move(g_1) - move(g_dp))| (`param_err`, the
    worst over every element; adamw_first_move), and the share of elements
    whose implied difference passes 1e-5 (`moved_share`) and the largest
    (`moved_max`) are reported."""
    got_p, want_p = dict(model.named_parameters()), dict(single.named_parameters())
    grad_err, param_err, moved_max, n_moved, n_elems, n_grads = 0.0, 0.0, 0.0, 0, 0, 0
    for n, p in want_p.items():
        diff = (got_p[n] - p).detach().double()
        n_elems += p.numel()
        if p.grad is None:
            param_err = max(param_err, diff.abs().max().item())
            continue
        n_grads += 1
        g = p.grad.abs().max()
        grad_err = max(grad_err, ((got_p[n].grad - p.grad).abs().max() / (1e-3 * g + 1e-6))
                       .item())
        implied = adamw_first_move(p.grad, lr) - adamw_first_move(got_p[n].grad, lr)
        param_err = max(param_err, (diff - implied).abs().max().item())
        moved_max = max(moved_max, implied.abs().max().item())
        n_moved += int((implied.abs() > 1e-5).sum())
    got = {k: float(v) for k, v in dp_losses.items()}
    want = {k: float(v) for k, v in single_losses.items()}
    return {"losses": got, "losses_single": want,
            "loss_err": max(abs(v - want[k]) / max(abs(want[k]), 1e-12) for k, v in got.items()),
            "grad_err": grad_err, "param_err": param_err, "moved_share": n_moved / n_elems,
            "moved_max": moved_max, "n_grads": n_grads, "lr": lr}


def _compare_body(args):
    """One rank of compare_with_one_process."""
    import torch
    import torch.distributed as dist

    from ..eval.decode import extract_dets_from_outputs
    from ..models.criterion import SetCriterion
    from ..models.monodetr import build_monodetr
    from ..train.optimizer import build_optimizer
    from ..train.synthetic import SyntheticLoader
    from ..train.train_step import TARGET_KEYS, batch_to_device, make_train_step
    from ..utils import trace
    from .ddp import DataParallel, init_distributed, make_parallel_eval_step, rank_device

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = init_distributed(args.device, args.backend)
    dev = rank_device(args.device)
    dp = DataParallel()
    cfg = dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep", dtype="float32",
               enc_layers=args.enc_layers, dec_layers=args.dec_layers, dropout=0.0)
    opt_cfg, lr = {"type": "adamw", "lr": 2e-4, "weight_decay": 1e-4}, 2e-4
    batch, _ = next(iter(SyntheticLoader(1, world * args.batch, 5, args.height, args.width)))
    whole = batch_to_device(batch, dev)
    mine = batch_to_device({k: dp.shard(v) for k, v in batch.items()}, dev)
    crit = SetCriterion(cfg)

    model = build_monodetr(cfg, seed=rank).to(dev)  # rank 0's weights come by broadcast
    dp.broadcast_(model)
    with torch.no_grad():
        out = model(mine["images"], mine["calibs"], mine["img_sizes"], train=True)
        shares = crit(out, {k: mine[k] for k in TARGET_KEYS}, dp=dp)
    keys = sorted(shares)
    all_shares = dp.gather(torch.stack([shares[k] for k in keys])[None])
    dets = make_parallel_eval_step(model, dp)(mine["images"], mine["calibs"], mine["img_sizes"])
    step = make_train_step(model, crit, build_optimizer(opt_cfg, model), dp=dp)
    losses = step(mine, lr).as_dict()
    # the port kernels the step launched, forward and backward (its span's counts)
    counted = trace.last("train step", 1)[0].counts
    launches = {name: counted.get(name, 0) for name in COUNTED}
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    n_equal = int(dp.sum(torch.tensor([float(torch.equal(flat, ref))], device=dev)).item())

    if rank == 0:
        single = build_monodetr(cfg, seed=0).to(dev)
        with torch.no_grad():
            out = single(whole["images"], whole["calibs"], whole["img_sizes"], train=True)
            terms = crit(out, {k: whole[k] for k in TARGET_KEYS})
            want_dets = extract_dets_from_outputs(
                single(whole["images"], whole["calibs"], whole["img_sizes"]), topk=50)
        want = make_train_step(single, crit, build_optimizer(opt_cfg, single))(whole, lr)
        report = step_report(model, single, losses, want.as_dict(), lr)
        report.update(
            share_keys=keys, shares=all_shares.tolist(),
            terms_single=[float(terms[k]) for k in keys], dets_shape=list(dets.shape),
            dets_err=((dets - want_dets).abs() / (1 + want_dets.abs())).max().item(),
            n_equal=n_equal, world=world, launches=launches, device=str(dev),
            backend=dist.get_backend())
        with open(args.report, "w") as f:
            json.dump(report, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compare"]:
        parser = argparse.ArgumentParser()
        parser.add_argument("--compare", action="store_true")
        parser.add_argument("--device", default="cpu")
        parser.add_argument("--backend")
        for name in ("height", "width", "batch", "enc-layers", "dec-layers"):
            parser.add_argument("--" + name, type=int)
        parser.add_argument("--report")
        _compare_body(parser.parse_args())
    elif len(sys.argv) == 2 and sys.argv[1].isdigit():
        dryrun_multichip(int(sys.argv[1]))
    else:
        sys.exit("usage: python -m monodetr_torch.parallel.dryrun N")
