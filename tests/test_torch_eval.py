"""monodetr_torch eval path and guards: decode against the JAX package,
the checkpoint conversion round trip, the smoke's model dict, the KITTI AP
evaluation against the JAX dataset's, the CLI (evaluation and one epoch of
training) on the synthetic KITTI fixture (no jax imported, no module of the
JAX package loaded), and
chip_smoke.py refusing to run without a CUDA card."""

import os
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

sys.path.insert(0, "tools")
from convert_checkpoint import convert_state_dict  # noqa: E402

from monodetr_tpu.data import KITTIDataset  # noqa: E402
from monodetr_tpu.data.kitti_utils import Calibration  # noqa: E402
from monodetr_tpu.eval import decode as jax_decode  # noqa: E402
from monodetr_torch.config import MONODETR_MODEL  # noqa: E402
from monodetr_torch.convert import params_from_jax  # noqa: E402
from monodetr_torch.data.kitti_utils import Calibration as TorchCalibration  # noqa: E402
from monodetr_torch.eval import decode  # noqa: E402
from monodetr_torch.eval import tester as torch_tester  # noqa: E402
from monodetr_torch.models.monodetr import build_monodetr  # noqa: E402
from tests.synthetic_kitti import make_synthetic_kitti  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(enc_layers=1, dec_layers=1, dtype="fp32")


def outputs(seed, B=2, Q=50):
    rng = np.random.RandomState(seed)
    return {
        "pred_logits": rng.randn(B, Q, 3).astype(np.float32) * 2,
        "pred_boxes": rng.rand(B, Q, 6).astype(np.float32) * 0.5 + 0.1,
        "pred_angle": rng.randn(B, Q, 24).astype(np.float32),
        "pred_3d_dim": rng.randn(B, Q, 3).astype(np.float32) * 0.3,
        "pred_depth": np.stack([rng.rand(B, Q) * 50 + 2, rng.randn(B, Q)], -1).astype(np.float32),
    }


@pytest.mark.parametrize("topk", [50, 20])
def test_extract_dets_matches_jax(topk):
    out = outputs(topk)
    got = decode.extract_dets_from_outputs({k: torch.from_numpy(v) for k, v in out.items()}, topk)
    want = jax_decode.extract_dets_from_outputs({k: jnp.asarray(v) for k, v in out.items()}, topk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_host_decode_and_txt_match_jax(tmp_path):
    dets = np.asarray(jax_decode.extract_dets_from_outputs(
        {k: jnp.asarray(v) for k, v in outputs(3).items()}, 50))
    p2 = np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2], [0, 0, 1, 0.003]],
                  np.float32)
    info = {"img_id": [7, 9], "img_size": [np.array([1242.0, 375.0])] * 2}
    mean_size = np.random.RandomState(4).rand(3, 3)
    got = decode.decode_detections(dets, info, [TorchCalibration.from_p2(p2)] * 2, mean_size,
                                   0.1)
    want = jax_decode.decode_detections(dets, info, [Calibration.from_p2(p2)] * 2,
                                        mean_size, 0.1)
    assert got.keys() == want.keys() and sum(map(len, got.values())) > 0
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64), rtol=1e-6, atol=1e-6)
    decode.save_results(got, str(tmp_path / "port"))
    jax_decode.save_results(want, str(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_smoke_model_dict_is_the_shipped_config():
    with open(os.path.join(REPO, "configs", "monodetr.yaml")) as f:
        assert yaml.safe_load(f)["model"] == MONODETR_MODEL


def test_params_from_jax_round_trips_through_convert_state_dict():
    sd = {k: v.numpy() for k, v in build_monodetr(dict(TINY, dec_layers=2), seed=3)
          .state_dict().items()}
    rng = np.random.RandomState(5)
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = (rng.rand(*sd[k].shape) + 0.5).astype(np.float32)
    tree = convert_state_dict(sd, enc_layers=1, dec_layers=2)
    back = convert_state_dict({k: v.numpy() for k, v in params_from_jax(tree).items()},
                              enc_layers=1, dec_layers=2)

    def leaves(t, p=""):
        for k, v in t.items():
            yield from (leaves(v, p + k + "/") if isinstance(v, dict) else [(p + k, v)])

    a, b = dict(leaves(tree)), dict(leaves(back))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-7, err_msg=k)
    with pytest.raises(KeyError):
        params_from_jax({"params": dict(tree["params"], tgt_embed=np.zeros(3))})


def test_tester_loads_a_jax_checkpoint(tmp_path):
    """Tester.test() loads <save_path>/<model>/checkpoint_best.pth (a JAX
    checkpoint) through params_from_jax and writes one txt per image."""
    src = build_monodetr(TINY, seed=1)
    tree = convert_state_dict({k: v.numpy() for k, v in src.state_dict().items()},
                              enc_layers=1, dec_layers=1)
    run_dir = tmp_path / "outputs" / "m"
    run_dir.mkdir(parents=True)
    with open(run_dir / "checkpoint_best.pth", "wb") as f:
        pickle.dump({"epoch": 1, "model_state": tree}, f)

    kitti = make_synthetic_kitti(str(tmp_path / "kitti"), n_train=0, n_val=2, seed=3)

    class Loader:
        dataset = type("D", (), {"cls_mean_size": np.zeros((3, 3)),
                                 "label_dir": os.path.join(kitti, "training", "label_2"),
                                 "idx_list": ["000000", "000001"], "writelist": ["Car"]})

        def __iter__(self):
            rng = np.random.RandomState(0)
            yield ({"images": rng.randn(2, 128, 256, 3).astype(np.float32),
                    "calibs": np.tile(np.eye(3, 4, dtype=np.float32) * 700, (2, 1, 1)),
                    "img_sizes": np.tile(np.float32([[1242, 375]]), (2, 1))},
                   [{"img_id": i, "img_size": np.float32([1242, 375])} for i in range(2)])

    import logging

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        model = build_monodetr(TINY, seed=2)
        tester = torch_tester.Tester({"threshold": 0.0}, model, Loader(),
                                     logging.getLogger("t"), {"save_path": "outputs/"}, "m",
                                     device="cpu")
        results = tester.test()  # inference, then the AP evaluation
        assert sorted(os.listdir(tester.results_dir)) == ["000000.txt", "000001.txt"]
        assert 0.0 <= tester.evaluate() <= 100.0
    finally:
        os.chdir(cwd)
    for k, v in src.state_dict().items():
        if "running" not in k and ".bn" not in k and "downsample.1" not in k:
            torch.testing.assert_close(model.state_dict()[k], v)
    assert all(len(r) == 50 for r in results.values())


def test_evaluate_matches_the_jax_dataset_eval(tmp_path):
    """Car moderate AP3D_R40 of the same result txts (the labels, jittered
    and scored, plus a false positive) by the port's evaluator and by
    monodetr_tpu's KITTIDataset.eval."""
    import logging

    root = make_synthetic_kitti(str(tmp_path / "kitti"), n_train=1, n_val=4, seed=5)
    ds = KITTIDataset("val", {"root_dir": root, "writelist": ["Car"]})
    out = tmp_path / "results"
    out.mkdir()
    rng = np.random.RandomState(0)
    for idx in ds.idx_list:
        rows = []
        with open(os.path.join(ds.label_dir, idx + ".txt")) as f:
            for line in f.read().splitlines():
                v = line.split()
                nums = np.array(v[4:15], np.float64)
                nums[:4] += rng.randn(4) * 0.5  # 2-D box, px
                nums[8:11] += rng.randn(3) * 0.05  # 3-D location, m
                rows.append(" ".join(v[:4] + ["%.2f" % x for x in nums]
                                     + ["%.4f" % rng.rand()]))
        rows.append("Car 0.00 0 0.0 100.0 150.0 200.0 250.0 1.5 1.6 3.9 2.0 1.6 20.0 0.1 0.9")
        (out / (idx + ".txt")).write_text("\n".join(rows) + "\n")
    log = logging.getLogger("t")
    want = ds.eval(results_dir=str(out), logger=log)
    got = torch_tester.kitti_eval(str(out), ds.label_dir, ds.idx_list, ds.writelist, log)
    assert 0.0 < want < 100.0
    assert got == want


# after a CLI run: whether jax was imported, and every loaded module whose
# file lies under monodetr_tpu/ (loaded by name or by path)
JAX_PACKAGE_REPORT = (
    "import os; jpd = os.path.join(%r, 'monodetr_tpu') + os.sep; "
    "print('jax imported:', 'jax' in sys.modules); "
    "print('jax package modules:', sorted(n for n, m in list(sys.modules.items()) "
    "if os.path.abspath(getattr(m, '__file__', None) or '').startswith(jpd)))" % REPO)


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable] + args, cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_cli_evaluate_only_writes_kitti_txts_without_jax(tmp_path):
    make_synthetic_kitti(str(tmp_path / "kitti"), n_train=1, n_val=2, seed=7)
    with open(os.path.join(REPO, "configs", "monodetr.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"].update(root_dir=str(tmp_path / "kitti"), batch_size=2, resolution=[320, 128])
    cfg["model"].update(TINY)
    cfg["model_name"] = "smoke"
    cfg["tester"]["threshold"] = 0.0
    with open(tmp_path / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    tool = os.path.join(REPO, "tools", "train_val_torch.py")
    code = ("import runpy, sys; sys.argv = [%r, '--config', 'tiny.yaml', '-e', "
            "'--device', 'cpu']; "
            "runpy.run_path(%r, run_name='__main__'); " % (tool, tool)
            + JAX_PACKAGE_REPORT)
    proc = _run(["-c", code], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "jax imported: False" in proc.stdout
    assert "jax package modules: []" in proc.stdout
    txts = os.listdir(tmp_path / "outputs" / "smoke" / "outputs" / "data")
    assert len(txts) == 2  # one per val image
    rows = (tmp_path / "outputs" / "smoke" / "outputs" / "data" / txts[0]).read_text()
    assert len(rows.splitlines()) == 50 and all(len(r.split()) == 16 for r in rows.splitlines())

    # the default device is the CUDA card; without one the CLI refuses to
    # run rather than fall back to the CPU
    proc = _run([tool, "--config", "tiny.yaml", "-e"], tmp_path,
                dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_cli_trains_one_epoch_without_jax(tmp_path):
    """One epoch of 2 batches of the TINY model at 320x128 on the CPU: a
    checkpoint in the JAX format, the in-loop and final evaluation, no jax."""
    make_synthetic_kitti(str(tmp_path / "kitti"), n_train=4, n_val=2, seed=8)
    with open(os.path.join(REPO, "configs", "monodetr.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"].update(root_dir=str(tmp_path / "kitti"), batch_size=2, resolution=[320, 128])
    cfg["model"].update(TINY)
    cfg["model_name"] = "train_smoke"
    cfg["trainer"]["max_epoch"] = 1
    with open(tmp_path / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    tool = os.path.join(REPO, "tools", "train_val_torch.py")
    code = ("import runpy, sys; sys.argv = [%r, '--config', 'tiny.yaml', '--device', 'cpu']; "
            "runpy.run_path(%r, run_name='__main__'); " % (tool, tool)
            + JAX_PACKAGE_REPORT)
    proc = _run(["-c", code], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "jax imported: False" in proc.stdout
    assert "jax package modules: []" in proc.stdout
    run_dir = tmp_path / "outputs" / "train_smoke"
    with open(run_dir / "checkpoint.pth", "rb") as f:
        state = pickle.load(f)
    assert state["epoch"] == 1 and state["optimizer_state"]["step"] == 2
    tree = state["model_state"]["params"]
    assert tree["transformer"]["encoder_layer_0"]["ffn"]["linear1"]["kernel"].shape == (256, 256)
    log = "".join(p.read_text() for p in run_dir.glob("train.log.*"))
    assert "epoch 0 batch 0 | loss_detr" in log and "img/s" in log and "Best Result" in log
    assert len(os.listdir(run_dir / "outputs" / "data")) == 2


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """No CUDA device (this host, or CUDA_VISIBLE_DEVICES empty), or no repo
    beside the script: non-zero exit and no ok line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run([script], tmp_path, env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _mode_tester(tmp_path, mode, checkpoint, save_all):
    """A Tester whose load, inference and evaluate only record: (tester,
    the basenames it loaded, in order)."""
    cfg = {"mode": mode, "checkpoint": checkpoint}
    train_cfg = {"save_all": save_all, "save_path": str(tmp_path) + "/"}
    t = torch_tester.Tester(cfg, None, None, None, train_cfg, "m", device="cpu")
    loaded = []
    t.load = lambda path: loaded.append(os.path.basename(path))
    t.inference = lambda: list(loaded)
    t.evaluate = lambda: None
    os.makedirs(t.output_dir)
    return t, loaded


def _touch(d, name, mtime):
    p = os.path.join(d, name)
    with open(p, "wb") as f:
        f.write(b"x")
    os.utime(p, (mtime, mtime))


def test_tester_mode_all_visits_epoch_checkpoints_by_mtime(tmp_path):
    """tests/test_tester_modes.py's situation: N below `checkpoint` and
    names without a number are skipped; file age, not N, gives the order."""
    t, loaded = _mode_tester(tmp_path, "all", 10, True)
    for name, mtime in (("checkpoint_epoch_5.pth", 100), ("checkpoint.pth", 150),
                        ("checkpoint_best.pth", 160), ("checkpoint_epoch_x.pth", 170),
                        ("checkpoint_epoch_30.pth", 200), ("checkpoint_epoch_10.pth", 300),
                        ("checkpoint_epoch_20.pth", 250)):
        _touch(t.output_dir, name, mtime)
    want = ["checkpoint_epoch_30.pth", "checkpoint_epoch_20.pth", "checkpoint_epoch_10.pth"]
    assert t.test() == want and loaded == want


@pytest.mark.parametrize("mode", ["all", "single"])
def test_tester_mode_all_without_save_all_is_single(tmp_path, mode):
    t, loaded = _mode_tester(tmp_path, mode, 0, False)
    _touch(t.output_dir, "checkpoint_best.pth", 100)
    _touch(t.output_dir, "checkpoint_epoch_3.pth", 120)
    t.test()
    assert loaded == ["checkpoint_best.pth"]


def test_tester_single_mode_with_save_all_takes_the_epoch_checkpoint(tmp_path):
    t, loaded = _mode_tester(tmp_path, "single", 7, True)
    _touch(t.output_dir, "checkpoint_epoch_7.pth", 100)
    _touch(t.output_dir, "checkpoint_best.pth", 110)
    t.test()
    assert loaded == ["checkpoint_epoch_7.pth"]


@pytest.mark.parametrize("save_all", [False, True])
def test_tester_refuses_a_misspelt_mode(tmp_path, save_all):
    t, loaded = _mode_tester(tmp_path, "al", 0, save_all)
    _touch(t.output_dir, "checkpoint_best.pth", 100)
    with pytest.raises(ValueError, match="'al'"):
        t.test()
    assert loaded == []
