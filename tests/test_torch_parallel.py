"""Data parallel in monodetr_torch (parallel/ddp.py) on the CPU: real
processes joined by gloo, each under a time limit and killed when another
fails (parallel/dryrun.py:run_ranks), as tests/test_parallel.py and
tests/test_multihost.py hold the JAX package's SPMD step and its one
writer.

- Two ranks, each with 2 of a global batch of 4 (64x128, 1 + 2 layers, f32,
  dropout 0), against one process on the whole batch
  (parallel/dryrun.py:compare_with_one_process; rank 0 runs both and
  reports): the loss vector (rtol 1e-5), the summed gradients
  (1e-3 * max|g| + 1e-6 per tensor, the train step's tolerance) and the
  parameters after AdamW (each element within 1e-5 of the difference its
  two gradients imply: AdamW's first step divides a gradient by its own
  size, so two sums of a near-zero gradient that differ in rounding move
  it differently; such elements, implied past 1e-5, at most 0.1%;
  dryrun.py:adamw_first_move against the optimizer's own first step);
  each rank's loss terms are its shares, whose sum over ranks is the single-process term (rtol 1e-5);
  the parameters stay identical on every rank, bit for bit, though rank 1
  starts from other weights (the broadcast from rank 0); the parallel
  eval step's gathered detections equal the single-process decode
  (max |a - b| / (1 + |b|) <= 1e-5).
- Exactly one writer: both ranks try to save a checkpoint
  (Trainer._save_and_eval_epoch) and result txts (Tester.save_results)
  under distinct names; only rank 0's appear, and rank 1's evaluate is 0.
- the shell entries on the synthetic KITTI fixture: NGPU=2 train_torch.sh
  (torchrun, tools/train_val_torch.py in two ranks, --device cpu) writes
  one checkpoint, by rank 0, after one step of the global batch, and
  test_torch.sh evaluates it.
- dryrun_multichip(2) runs.
"""

import os
import pickle
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from monodetr_torch.parallel.dryrun import compare_with_one_process, dryrun_multichip, run_ranks
from monodetr_torch.utils.misc import is_main_process
from tests.synthetic_kitti import make_synthetic_kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300

_GATE_WORKER = r"""
import os, sys, types
import torch.distributed as dist
sys.path.insert(0, os.environ["REPO"])
from monodetr_torch.eval.tester import Tester
from monodetr_torch.models.monodetr import build_monodetr
from monodetr_torch.parallel.ddp import init_distributed
from monodetr_torch.train.optimizer import build_optimizer
from monodetr_torch.train.trainer import Trainer
from monodetr_torch.utils.misc import is_main_process

rank, world = init_distributed("cpu")
assert is_main_process() == (rank == 0)
outdir = os.environ["OUT"]
os.chdir(outdir)
logger = types.SimpleNamespace(info=lambda *a: None)
loader = types.SimpleNamespace(dataset=types.SimpleNamespace(cls_mean_size=None))
tester = Tester({"mode": "single"}, None, loader, logger, {"save_path": "out/"}, "m",
                device="cpu")
tester.save_results({rank: [[1, 0.0] + [1.0] * 12]})  # a txt per rank
assert rank == 0 or tester.evaluate() == 0.0

model = build_monodetr({"enc_layers": 1, "dec_layers": 1})
tr = object.__new__(Trainer)
tr.cfg = {"save_all": True}
tr.output_dir = os.path.join(outdir, "out", "m")
tr.model, tr.optimizer = model, build_optimizer({"type": "adamw"}, model)
tr.epoch = 3 + rank  # distinct names: a second writer leaves a second file
tr.best_result, tr.best_epoch = 0.0, 0
tr.tester = None
tr.logger = logger
tr._save_and_eval_epoch()
dist.barrier()
dist.destroy_process_group()
"""


def _ranks(script, tmp_path, n=2, **env):
    path = tmp_path / "worker.py"
    path.write_text(script)
    results = run_ranks([sys.executable, str(path)], n, TIMEOUT_S,
                        env=dict(env, REPO=REPO, OMP_NUM_THREADS="1"))
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} exited {rc}:\n{out[-3000:]}"
    return results


@pytest.fixture(scope="module")
def step_report():
    return compare_with_one_process(2, "cpu", timeout=TIMEOUT_S)


def test_two_rank_step_equals_the_single_process_step(step_report):
    r = step_report
    assert r["losses"].keys() == r["losses_single"].keys() and "loss_detr" in r["losses"]
    for k, v in r["losses"].items():
        np.testing.assert_allclose(v, r["losses_single"][k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert r["n_grads"] > 100 and r["backend"] == "gloo"
    assert r["grad_err"] <= 1.0, r["grad_err"]
    # every element to 1e-5 of the move its two gradients imply
    assert r["param_err"] <= 1e-5, r["param_err"]
    assert r["moved_share"] <= 1e-3, r["moved_share"]


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
def test_adamw_first_move_is_the_optimizers_first_step(weight_decay):
    from monodetr_torch.parallel.dryrun import adamw_first_move
    from monodetr_torch.train.optimizer import build_optimizer

    gen = torch.Generator().manual_seed(3)
    w = torch.nn.Parameter(torch.randn(4096, generator=gen))
    # gradients from 1e-12 to 1, both signs: the eps-dominated ones too
    g = torch.randn(4096, generator=gen) * 10.0 ** -torch.randint(0, 13, (4096,), generator=gen)
    w0 = w.detach().clone()
    w.grad = g.clone()
    opt = build_optimizer({"type": "adamw", "weight_decay": weight_decay}, _holder(w))
    opt.step(2e-4)
    # decoupled decay, scaled by the bias-corrected step (optimizer.py)
    decay = 2e-4 * (1 - 0.999) ** 0.5 / (1 - 0.9) * weight_decay * w0.double()
    want = w0.double() - adamw_first_move(g, 2e-4) - decay
    # to f32's rounding of the parameter (a few ulp) and of the step size,
    # which the optimizer computes in f32 (1 - b2 there is 1.3e-5 off:
    # 1.3e-9 of a 2e-4 move)
    torch.testing.assert_close(w.detach().double(), want, rtol=3e-7, atol=3e-9)


def _holder(w):
    m = torch.nn.Module()
    m.weight = w
    return m


def test_rank_shares_sum_to_the_single_process_terms(step_report):
    r = step_report
    shares = np.asarray(r["shares"])
    assert shares.shape == (r["world"], len(r["share_keys"])) == (2, 2 + 7 * 2)
    np.testing.assert_allclose(shares.sum(0), r["terms_single"], rtol=1e-5, atol=1e-7)
    # the box-normalised terms split by image, not in halves of the mean
    assert not np.allclose(shares[0], shares[1])


def test_parameters_are_identical_on_every_rank(step_report):
    assert step_report["n_equal"] == step_report["world"] == 2


def test_parallel_eval_equals_the_single_process_decode(step_report):
    assert step_report["dets_shape"] == [4, 50, 37]
    assert step_report["dets_err"] <= 1e-5


def test_exactly_one_writer(tmp_path):
    _ranks(_GATE_WORKER, tmp_path, OUT=str(tmp_path))
    run_dir = tmp_path / "out" / "m"
    assert sorted(p.name for p in run_dir.glob("checkpoint*")) == ["checkpoint_epoch_3.pth"]
    assert sorted(os.listdir(run_dir / "outputs" / "data")) == ["000000.txt"]


def _shell(args, cwd, env):
    """Run a shell entry in its own session; on a timeout kill the whole
    group (torchrun and its workers)."""
    proc = subprocess.Popen(["bash"] + args, cwd=cwd, env=dict(os.environ, **env),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, out


def test_shell_entries_train_in_two_ranks_and_evaluate(tmp_path):
    """NGPU=2 bash train_torch.sh (torchrun, 2 ranks, --device cpu): a
    global batch of 4 over 4 training images is one step; rank 0 writes the
    one checkpoint and the 2 validation txts.  Then bash test_torch.sh
    evaluates that checkpoint."""
    make_synthetic_kitti(str(tmp_path / "kitti"), n_train=4, n_val=2, seed=8)
    with open(os.path.join(REPO, "configs", "monodetr.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"].update(root_dir=str(tmp_path / "kitti"), batch_size=4, resolution=[320, 128])
    cfg["model"].update(enc_layers=1, dec_layers=1, dtype="fp32")
    cfg["model_name"] = "dp_smoke"
    cfg["trainer"]["max_epoch"] = 1
    config = str(tmp_path / "tiny.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    env = {"NGPU": "2", "OMP_NUM_THREADS": "1"}
    rc, out = _shell([os.path.join(REPO, "train_torch.sh"), config, "--device", "cpu"],
                     tmp_path, env)
    assert rc == 0, out[-3000:]
    run_dir = tmp_path / "outputs" / "dp_smoke"
    assert sorted(p.name for p in run_dir.glob("checkpoint*")) == ["checkpoint.pth"]
    with open(run_dir / "checkpoint.pth", "rb") as f:
        state = pickle.load(f)
    assert state["epoch"] == 1 and state["optimizer_state"]["step"] == 1
    assert len(os.listdir(run_dir / "outputs" / "data")) == 2
    log = "".join(p.read_text() for p in run_dir.glob("train.log.*"))
    assert "data parallel: 2 ranks" in log and "epoch 0 batch 0 | loss_detr" in log

    shutil.rmtree(run_dir / "outputs")
    rc, out = _shell([os.path.join(REPO, "test_torch.sh"), config, "--device", "cpu"],
                     tmp_path, {"OMP_NUM_THREADS": "1"})
    assert rc == 0, out[-3000:]
    assert len(os.listdir(run_dir / "outputs" / "data")) == 2


def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip(2, timeout=TIMEOUT_S)
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): one DP train step OK" in out
    assert "parameters identical on all 2 ranks" in out


def test_is_main_process_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert is_main_process()
