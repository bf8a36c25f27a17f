"""The handoff of the loader's numpy batches to the card, overlapped with
the step (the JAX trainer's "host->device transfer overlapped by
prefetch", monodetr_tpu/train/trainer.py:8).

`DevicePrefetcher` wraps a loader (data/loader.py:DataLoader, or anything
yielding (batch, infos) with the train/train_step.py:BATCH_KEYS arrays).
On a CUDA device a background thread takes each batch from the loader,
copies it into pinned host memory and queues its copies to the card on a
side stream (train_step.batch_to_device), and records an event after them;
the consumer's stream waits on that event and every device tensor is
marked as used by the consumer's stream (`record_stream`), so the caching
allocator does not hand its memory to the side stream while the step still
reads it.  Batch k+1's copy then overlaps step k's kernels, and nothing in
the handoff makes the host wait for the card.  On the CPU the batches are
converted in the consumer's thread, one at a time.

The consumer's wait for each next batch (on the CPU, the loader's work) is
the root span `data wait` (utils/trace.py); on a CUDA device each batch's
`batch_to_device` is a root of the background thread.
"""

import queue
import threading

import torch

from ..train.train_step import BATCH_KEYS, batch_to_device
from ..utils.trace import span

# batches whose copies may be queued ahead of the consumer: the next one,
# and one more while the consumer takes it
DEPTH = 2
_END = object()


class DevicePrefetcher:
    """Iterates (device batch, numpy batch, infos) over `loader`, the device
    batch being batch_to_device(numpy batch, device, keys): the training
    batch, or the eval forward's inputs (eval/tester.py:EVAL_KEYS)."""

    def __init__(self, loader, device, keys=BATCH_KEYS):
        self.loader = loader
        self.device = torch.device(device)
        self.keys = keys

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        if self.device.type != "cuda":
            for batch, infos in waited(iter(self.loader)):
                yield batch_to_device(batch, self.device, self.keys), batch, infos
            return
        yield from self._cuda_batches()

    def _cuda_batches(self):
        device = self.device
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        consumer = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)

        def staged():  # runs in the background thread
            with torch.cuda.device(device), torch.cuda.stream(side):
                for batch, infos in self.loader:
                    on_card = batch_to_device(batch, device, self.keys)
                    ready = torch.cuda.Event()
                    ready.record(side)
                    yield on_card, ready, batch, infos

        for on_card, ready, batch, infos in waited(in_background(staged, DEPTH)):
            consumer.wait_event(ready)
            for t in on_card.values():
                t.record_stream(consumer)
            yield on_card, batch, infos


def waited(items):
    """Yields the iterator's items, each fetch in a span `data wait`: a
    root of the consumer's thread, outside the step that takes the item."""
    while True:
        with span("data wait"):
            item = next(items, _END)
        if item is _END:
            return
        yield item


def in_background(make_items, depth):
    """Yields the items of the generator `make_items()`, which runs in a
    thread of its own up to `depth` items ahead of the consumer.  An
    exception there is raised here, after the items before it; when the
    consumer stops early, the thread closes the iterator at its next item
    and ends."""
    ready_q = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item):
        while not stop.is_set():
            try:
                ready_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        items = make_items()
        try:
            for item in items:
                if not put((item, None)):
                    return
            put((done, None))
        except BaseException as e:  # surfaced to the consumer, which re-raises
            put((None, e))
        finally:
            items.close()

    producer = threading.Thread(target=produce, name="device-prefetch", daemon=True)
    producer.start()
    try:
        while True:
            item, error = ready_q.get()
            if error is not None:
                raise error
            if item is done:
                return
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer waiting to put
            try:
                ready_q.get_nowait()
            except queue.Empty:
                break
        producer.join(timeout=60)
