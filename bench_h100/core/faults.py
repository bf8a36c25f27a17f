"""Faults planted in the program under test, to show that the output check
fails a broken timed path: each is a context manager that patches one
entry of monodetr_torch and puts it back.

frozen_state    (train) the optimizer step leaves the parameters and its
                state unchanged;
lost_offsets    (train) the gradient of the decoder's sampling offsets (a
                weight and a bias in each layer) is lost on its way to the
                optimizer: a fault confined to a few leaves;
half_batch      (train) the losses are taken over the first half of the
                batch, its mean over those images; (stream) the eval
                step computes the first half of the images and repeats it
                for the rest (with one image, the previous call's output);
altered_answer  (stream) one detection's depth is moved by 10 m in the
                copy that reaches the host, and one KITTI row's score by
                0.1 where the decode makes it;
lowest_picks    (train, a program that picks proposals) the proposal
                top-k takes the lowest-scoring tokens, lowest first.
"""

import contextlib

import torch


@contextlib.contextmanager
def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def frozen_state():
    from monodetr_torch.train import optimizer

    with _patch(optimizer.RefAdamW, "step", lambda self, lr: None):
        yield


@contextlib.contextmanager
def lost_offsets():
    from monodetr_torch.models import monodetr

    build = monodetr.build_monodetr

    def broken(cfg):
        model = build(cfg)
        for name, p in model.named_parameters():
            if ".decoder." in name and ".cross_attn.sampling_offsets." in name:
                p.register_hook(torch.zeros_like)
        return model

    with _patch(monodetr, "build_monodetr", broken):
        yield


@contextlib.contextmanager
def half_batch_train():
    from monodetr_torch.models import criterion

    call = criterion.SetCriterion.__call__

    def half(self, outputs, targets, train=True, dp=None):
        n = targets["mask"].shape[0] // 2

        def cut(x):
            if isinstance(x, dict):
                return {k: cut(v) for k, v in x.items()}
            if isinstance(x, list):
                return [cut(v) for v in x]
            return x[:n]

        return call(self, cut(outputs), cut(targets), train, dp)

    with _patch(criterion.SetCriterion, "__call__", half):
        yield


@contextlib.contextmanager
def half_batch_eval():
    from monodetr_torch.train import train_step

    make = train_step.make_eval_step
    last = []

    def broken(model, topk=50, threshold=0.2):
        step = make(model, topk, threshold)

        def eval_step(images, calibs, img_sizes):
            B = images.shape[0]
            if B == 1:
                out = last[0] if last else step(images, calibs, img_sizes)
                last[:] = [step(images, calibs, img_sizes)]
                return out
            n = B // 2
            out = step(images[:n], calibs[:n], img_sizes[:n])
            return torch.cat([out, out[:B - n]])

        return eval_step

    with _patch(train_step, "make_eval_step", broken):
        yield


@contextlib.contextmanager
def altered_answer():
    from monodetr_torch.eval import decode

    extract, dec = decode.extract_dets_from_outputs, decode.decode_detections

    def extract_altered(outputs, topk=50):
        dets = extract(outputs, topk).clone()
        dets[:, 0, 6] += 10.0
        return dets

    def decode_altered(*args, **kwargs):
        results = dec(*args, **kwargs)
        for rows in results.values():
            if rows:
                rows[0][-1] += 0.1
                break
        return results

    with _patch(decode, "extract_dets_from_outputs", extract_altered), \
            _patch(decode, "decode_detections", decode_altered):
        yield


@contextlib.contextmanager
def lowest_picks():
    from monodetr_torch.models import transformer

    forward = transformer.DepthAwareTransformer.forward
    topk = torch.Tensor.topk

    def lowest(self, k, dim=-1, largest=True, sorted=True):
        return topk(self, k, dim=dim, largest=not largest, sorted=sorted)

    def broken(self, *args, **kwargs):
        with _patch(torch.Tensor, "topk", lowest):
            return forward(self, *args, **kwargs)

    with _patch(transformer.DepthAwareTransformer, "forward", broken):
        yield


FAULTS = {"train": {"frozen_state": frozen_state, "half_batch": half_batch_train,
                    "lost_offsets": lost_offsets},
          "stream": {"half_batch": half_batch_eval, "altered_answer": altered_answer}}
# faults that only a program that picks proposals can have
PICK_FAULTS = {"train": {"lowest_picks": lowest_picks}, "stream": {}}


def planted(kind, name):
    """The fault `name` of a cell of `kind`."""
    return {**FAULTS[kind], **PICK_FAULTS[kind]}[name]
