"""Host-side batched loader with threaded prefetch.

Replaces the reference's torch DataLoader (dataloader_helper.py:12-36,
4 workers, per-worker seeding, train shuffle, no drop_last).  Design for TPU
feeding:

  - fixed batch shapes: a trailing partial batch is padded by repeating the
    last sample with an all-False target mask and `valid` flags, so XLA
    compiles exactly one program per phase;
  - a small thread pool decodes/warps images concurrently (PIL/cv2 release
    the GIL) and a background thread keeps `prefetch` batches ready while
    the device computes;
  - per-epoch reseeding hook matching trainer_helper.py:74.
"""

import multiprocessing
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np

# Process-pool worker plumbing: the dataset is published as a module global
# BEFORE the fork so children inherit it by COW page sharing; the mapped
# function is module-level so only its qualified name + an int index cross
# the task pipe (the bound method `dataset.__getitem__` would re-pickle the
# whole dataset per map call).
#
# Fork-after-JAX hazard: worker_mode='process' forks from a process that is
# already multithreaded (the JAX/TPU runtime plus this loader's producer
# threads), and fork() only survives the calling thread — a child forked
# while another thread holds an internal lock can deadlock.  The children
# here only run numpy/PIL dataset code (never JAX), which keeps the window
# small but not zero; prefer 'thread' (the default) unless host-side python
# demonstrably caps throughput on a many-core machine (PERF.md "Loader
# worker modes").  _PROC_LOCK serializes pool creation so two loaders can't
# clobber each other's _PROC_DATASET between publish and fork.
_PROC_DATASET = None
_PROC_LOCK = threading.Lock()


def _proc_init(counter, base_seed):
    """Forked children inherit the parent's np.random state bit-for-bit;
    reseed each worker distinctly (the reference's worker_init_fn concern,
    dataloader_helper.py:20-23) so augmentation streams decorrelate."""
    with counter.get_lock():
        rank = counter.value
        counter.value += 1
    np.random.seed((base_seed * 1000 + rank) % (2 ** 31))


def _proc_get(i):
    return _PROC_DATASET[i]


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 num_workers: int = 4, seed: int = 444, prefetch: int = 2,
                 drop_last: bool = False, process_shard=None,
                 worker_mode: str = "thread"):
        """process_shard: None (single host) or (process_index,
        process_count) for multi-host DP.  batch_size is then the GLOBAL
        batch; every process derives the same index order (same
        seed/epoch) and loads only rows
        [pi*local : (pi+1)*local] of each global batch, which is exactly
        the addressable shard `jax.make_array_from_process_local_data`
        expects for a 1-D data mesh in process order (parallel/mesh.py
        shard_batch_fn).

        worker_mode: 'thread' (ThreadPoolExecutor; decode/warp release the
        GIL so this scales while the python-side target encode stays under
        one core's worth) or 'process' (forked worker processes, the
        reference DataLoader's num_workers model,
        dataloader_helper.py:12-36 — full GIL isolation; samples return
        over pipes as pickled numpy, ~2-3 ms/img vs the ~26 ms/img
        decode+warp they parallelize)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}")
        self.worker_mode = worker_mode
        if process_shard is not None:
            pi, pc = process_shard
            if batch_size % pc != 0:
                raise ValueError(
                    f"global batch {batch_size} not divisible by "
                    f"process_count {pc}")
            self.process_shard = (int(pi), int(pc))
        else:
            self.process_shard = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_order(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            return rng.permutation(n)
        return np.arange(n)

    def _collate(self, samples, n_valid) -> Tuple[Dict[str, np.ndarray], List]:
        imgs = np.stack([s[0] for s in samples])
        calibs = np.stack([s[1] for s in samples])
        targets = {
            k: np.stack([s[2][k] for s in samples])
            for k in samples[0][2].keys()
        }
        # per-object calib copies (reference targets['calibs']) under a
        # distinct key; batch['calibs'] is the image-level P2
        targets["obj_calibs"] = targets.pop("calibs")
        infos = [s[3] for s in samples]
        batch = {
            "images": imgs.astype(np.float32),
            "calibs": calibs.astype(np.float32),
            "img_sizes": targets.pop("img_size"),
            "valid": (np.arange(len(samples)) < n_valid),
            **targets,
        }
        # padded samples contribute no targets
        batch["mask"] = batch["mask"] & batch["valid"][:, None]
        return batch, infos[:n_valid]

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], List]]:
        order = self._index_order()
        n = len(order)
        batches = []
        for s in range(0, n, self.batch_size):
            idxs = order[s:s + self.batch_size].tolist()
            if len(idxs) < self.batch_size:
                if self.drop_last:
                    continue
                pad = self.batch_size - len(idxs)
                idxs = idxs + [idxs[-1]] * pad
                batches.append((idxs, self.batch_size - pad))
            else:
                batches.append((idxs, self.batch_size))

        if self.process_shard is not None:
            pi, pc = self.process_shard
            local = self.batch_size // pc
            lo = pi * local
            batches = [
                (idxs[lo:lo + local],
                 int(np.clip(n_valid - lo, 0, local)))
                for idxs, n_valid in batches
            ]

        if self.worker_mode == "process":
            global _PROC_DATASET
            with _PROC_LOCK:
                _PROC_DATASET = self.dataset
                ctx = multiprocessing.get_context("fork")
                counter = ctx.Value("i", 0)
                pool = ctx.Pool(self.num_workers, initializer=_proc_init,
                                initargs=(counter, self.seed + self.epoch))
            fetch = lambda idxs: pool.map(_proc_get, idxs)
            shutdown = pool.terminate
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            fetch = lambda idxs: list(
                pool.map(self.dataset.__getitem__, idxs))
            shutdown = lambda: pool.shutdown(wait=False)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                for idxs, n_valid in batches:
                    if stop.is_set():
                        return
                    out_q.put(self._collate(fetch(idxs), n_valid))
                out_q.put(None)
            except BaseException as e:  # surface worker errors to the consumer
                out_q.put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            shutdown()


def build_dataloader(cfg: Dict[str, Any], workers: int = 4,
                     process_shard=None):
    """(train_loader, test_loader) — dataloader_helper.build_dataloader.

    process_shard: forwarded to the TRAIN DataLoader for multi-host DP
    (each host loads its slice of every global batch).  The test loader is
    never sharded: evaluation runs on process 0 only (reference
    is_main_process semantics — trainer/tester gate writes and eval), so
    process 0 must see the whole val set."""
    from .kitti_dataset import KITTIDataset

    worker_mode = cfg.get("worker_mode", "thread")
    train_set = KITTIDataset(split=cfg["train_split"], cfg=cfg)
    test_set = KITTIDataset(split=cfg["test_split"], cfg=cfg)
    train_loader = DataLoader(
        train_set, batch_size=cfg["batch_size"], shuffle=True,
        num_workers=workers, process_shard=process_shard,
        worker_mode=worker_mode,
    )
    test_loader = DataLoader(
        test_set, batch_size=cfg["batch_size"], shuffle=False,
        num_workers=workers, worker_mode=worker_mode,
    )
    return train_loader, test_loader
