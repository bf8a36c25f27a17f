"""The handoff of batches to the device (monodetr_torch/data/
device_prefetch.py, train/train_step.py:batch_to_device) and the eval
step (train/train_step.py:make_eval_step), on the CPU.

- The prefetcher yields the loader's batches in order, each with the
  numpy batch and infos the loader gave, its device batch equal bit for
  bit to batch_to_device of that batch; a loader error reaches the
  consumer; a data-parallel rank's loader slice passes through unchanged.
- Its background thread (in_background, the CUDA path's machinery, which
  has no device in it) keeps the order, re-raises an error after the
  items before it, and stops and closes its source when the consumer
  stops early.
- make_eval_step against monodetr_tpu's make_eval_step on the same
  weights at 128x256, 2+2 layers, f32: rtol and atol 1e-3, the whole
  forward's tolerance of tests/test_torch_model.py.
The CUDA path itself (pinned copies on a side stream, no synchronizing
call) is held on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, "tools")
from convert_checkpoint import convert_state_dict  # noqa: E402

from monodetr_tpu.models import build_monodetr as jax_build  # noqa: E402
from monodetr_tpu.train.train_step import make_eval_step as jax_make_eval_step  # noqa: E402
from monodetr_torch.convert import params_from_jax  # noqa: E402
from monodetr_torch.data import KITTIDataset  # noqa: E402
from monodetr_torch.data.device_prefetch import DevicePrefetcher, in_background  # noqa: E402
from monodetr_torch.data.loader import DataLoader  # noqa: E402
from monodetr_torch.eval.tester import EVAL_KEYS  # noqa: E402
from monodetr_torch.models.monodetr import build_monodetr  # noqa: E402
from monodetr_torch.parallel.ddp import DataParallel  # noqa: E402
from monodetr_torch.train import make_eval_step  # noqa: E402
from monodetr_torch.train.synthetic import SyntheticLoader  # noqa: E402
from monodetr_torch.train.train_step import BATCH_KEYS, batch_to_device  # noqa: E402
from tests.synthetic_kitti import make_synthetic_kitti  # noqa: E402

torch.set_num_threads(2)


def assert_same_batch(on_card, batch, keys=BATCH_KEYS):
    want = batch_to_device(batch, "cpu", keys)
    assert list(on_card) == list(keys)
    for k in keys:
        assert on_card[k].dtype == want[k].dtype, k
        assert torch.equal(on_card[k], want[k]), k


@pytest.mark.parametrize("keys", [BATCH_KEYS, EVAL_KEYS])
def test_prefetcher_yields_the_loaders_batches_in_order(keys):
    loader = SyntheticLoader(3, 2, 5, 32, 64)
    want = list(loader)
    got = list(DevicePrefetcher(loader, "cpu", keys))
    assert len(got) == len(want) == 3
    for (on_card, batch, infos), (wbatch, winfos) in zip(got, want):
        assert [i["img_id"] for i in infos] == [i["img_id"] for i in winfos]
        for k in wbatch:
            np.testing.assert_array_equal(batch[k], wbatch[k])
        assert_same_batch(on_card, batch, keys)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    return make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti")), n_train=4, n_val=2,
                                seed=11)


def dataset(root):
    return KITTIDataset("train", {"root_dir": root, "writelist": ["Car"],
                                  "resolution": [320, 128], "random_flip": 0.0,
                                  "random_crop": 0.0})


def test_prefetcher_passes_a_real_loaders_batches(kitti):
    """The port's DataLoader over synthetic KITTI PNGs (a padded last
    batch): the prefetched device batch is batch_to_device of the very
    numpy batch yielded beside it, and the order is the loader's."""
    loader = DataLoader(dataset(kitti), batch_size=3, shuffle=True, num_workers=2)
    loader.set_epoch(1)
    got = list(DevicePrefetcher(loader, "cpu"))
    assert len(got) == len(loader) == 2
    ids = [i["img_id"] for _, _, infos in got for i in infos]
    order = loader._index_order()
    assert ids == [int(loader.dataset.idx_list[j]) for j in order]
    for on_card, batch, _ in got:
        assert_same_batch(on_card, batch)
    assert not got[1][0]["mask"][1:].any()  # the padded rows carry no targets


@pytest.mark.parametrize("rank", [0, 1])
def test_a_data_parallel_ranks_slice_is_unchanged(kitti, rank):
    """A rank's loader (process_shard) through the prefetcher gives that
    rank's rows of the global batch (DataParallel.shard), as the loader
    alone does."""
    ds = dataset(kitti)
    whole = list(DataLoader(ds, batch_size=4, shuffle=True, num_workers=1))
    mine = list(DevicePrefetcher(
        DataLoader(ds, batch_size=4, shuffle=True, num_workers=1, process_shard=(rank, 2)),
        "cpu"))
    dp = types.SimpleNamespace(rank=rank, world=2)
    assert len(mine) == len(whole) == 1
    (on_card, batch, infos), (wbatch, winfos) = mine[0], whole[0]
    assert [i["img_id"] for i in infos] == [i["img_id"] for i in winfos][2 * rank:2 * rank + 2]
    shard = {k: DataParallel.shard(dp, v) for k, v in wbatch.items()}
    assert_same_batch(on_card, shard)
    for k in BATCH_KEYS:
        np.testing.assert_array_equal(batch[k], shard[k])


class Failing:
    """A loader whose second batch raises."""

    def __iter__(self):
        yield next(iter(SyntheticLoader(1, 1, 0, 16, 32)))
        raise OSError("disk read failed")


def test_prefetcher_surfaces_a_loader_error():
    seen = []
    with pytest.raises(OSError, match="disk read failed"):
        for item in DevicePrefetcher(Failing(), "cpu"):
            seen.append(item)
    assert len(seen) == 1


def test_background_thread_keeps_order_and_raises_after_the_items_before():
    def items():
        for i in range(5):
            yield i
        raise ValueError("producer failed")

    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for x in in_background(items, depth=2):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]
    assert list(in_background(lambda: (i for i in range(7)), depth=1)) == list(range(7))


def test_background_thread_stops_when_the_consumer_stops():
    """Breaking out after 2 of an endless source: the producer ends and
    the source is closed (its finally runs), within the join's time."""
    closed = threading.Event()
    before = {t.ident for t in threading.enumerate()}

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    it = in_background(endless, depth=2)
    got = [next(it), next(it)]
    it.close()
    assert got == [0, 1]
    assert closed.wait(10)
    deadline = time.time() + 10
    while time.time() < deadline and any(
            t.name == "device-prefetch" and t.ident not in before for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "device-prefetch" and t.ident not in before
                   for t in threading.enumerate())


def test_batch_to_device_on_the_cpu_takes_the_arrays_as_they_are():
    batch, _ = next(iter(SyntheticLoader(1, 2, 1, 16, 32)))
    batch["mask"] = batch["mask"].astype(np.uint8)  # made bool on the way
    out = batch_to_device(batch, "cpu")
    assert out["mask"].dtype == torch.bool
    assert out["images"].data_ptr() == torch.from_numpy(batch["images"]).data_ptr()
    assert not out["images"].is_pinned()


# make_eval_step against JAX (the weights of tests/test_torch_model.py)
IMG_H, IMG_W, B = 128, 256, 2
CFG = dict(msda_impl="fused", msda_window=6, dec_msda_impl="sep", dtype="float32",
           enc_layers=2, dec_layers=2)


@pytest.mark.parametrize("topk", [50, 20])
def test_make_eval_step_matches_jax(topk):
    rng = np.random.RandomState(0)
    sd = {k: v.numpy().copy() for k, v in build_monodetr(CFG, seed=0).state_dict().items()}
    for k, v in sd.items():
        if k.endswith("running_var") or (".bn" in k and k.endswith("weight")):
            sd[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        elif k.endswith("running_mean") or (".bn" in k and k.endswith("bias")):
            sd[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith("sampling_offsets.weight"):
            sd[k] = (rng.randn(*v.shape) * 0.03).astype(np.float32)
        elif k.endswith("attention_weights.weight"):
            sd[k] = (rng.randn(*v.shape) * 0.05).astype(np.float32)
    tree = convert_state_dict(sd, enc_layers=2, dec_layers=2)
    model = build_monodetr(CFG)
    model.load_state_dict(params_from_jax(tree))
    model.train()  # the eval step switches to eval itself

    rng = np.random.RandomState(1)
    images = rng.randn(B, IMG_H, IMG_W, 3).astype(np.float32)
    calibs = np.tile(np.array([[700.0, 0, 600, 45], [0, 700, 170, 0], [0, 0, 1, 0]],
                              np.float32), (B, 1, 1))
    calibs[1, 0, 0] = 650.0
    sizes = np.tile(np.array([[1242.0, 375.0]], np.float32), (B, 1))

    jax_model = jax_build(dict(CFG, msda_impl="windowed"))
    want = np.asarray(jax_make_eval_step(jax_model, topk=topk)(
        {"params": tree["params"]}, images, calibs, sizes))
    got = make_eval_step(model, topk=topk)(
        *(torch.from_numpy(x) for x in (images, calibs, sizes)))
    assert not model.training and not got.requires_grad
    assert got.shape == want.shape == (B, topk, 37)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
