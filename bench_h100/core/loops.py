"""The two loops that a mix's `kind` selects, each driving the program
(monodetr_torch) through its own entry points, and then the reference
check of what the timed path produced.

train   make_train_step at the mix's constant learning rate on a pool of
        batches, cycled.  Set-up builds the one step object and drives its
        first `checked_steps` steps, whose losses, first gradient (the
        optimizer's first moment) and parameter change the check reads;
        then `warmup_steps` more, then the window.
stream  one frame in flight: batch_to_device, make_eval_step (top-k), the
        copy of the detections to the host, decode_detections.

Each returns the run's record for the metric readers and the check's
numbers.  `device` is "cuda" on the card; the tests pass "cpu", where the
program runs its plain versions.
"""

import gc
import time

import numpy as np
import torch

from ..reference import steps as ref_steps
from . import check, spec, trace as tr
from .traffic import Traffic, sub_seeds
from .weights import class_bias, make_state, set_class_bias

ADAM_B1 = 0.9


class Run:
    def __init__(self, config, mix, seed, seconds, traced, device, t0):
        self.config, self.mix = config, mix
        self.seconds, self.traced, self.device, self.t0 = seconds, traced, device, t0
        self.arch = spec.reference(config)
        self.seeds = sub_seeds(seed, 5)  # images, host data, weights, dropout, sample
        self.traffic = Traffic(mix, config, *self.seeds[:2])
        self.record = {"kind": mix["kind"], "counts": config["counts"],
                       "model": config["model"], "batch": mix["batch"]}
        self.bias = None

    def sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def state(self):
        """The weights both sides start from; the first call sets the class
        bias on the reference's forward of a calibration frame and then
        forgets that forward's memory peak."""
        state = make_state(self.arch, self.seeds[2], self.config, self.device)
        if self.bias is None:
            t = time.perf_counter()
            self.bias = class_bias(self.arch, self.config, state,
                                   *self.traffic.calibration_frame(self.device), self.device)
            if self.device != "cpu":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            self.record["calibration_s"] = time.perf_counter() - t
        return set_class_bias(state, self.bias)

    def program_model(self):
        from monodetr_torch.models.monodetr import build_monodetr

        with torch.device(self.device):
            model = build_monodetr(dict(self.config["model"]))
        model.to(self.device)
        model.load_state_dict(self.state())
        return model

    def autocast(self):
        from monodetr_torch.models.monodetr import compute_dtype

        dtype = compute_dtype(self.config["model"])
        return torch.autocast(torch.device(self.device).type, dtype=dtype,
                              enabled=dtype != torch.float32)

    def profiled(self, body, steps):
        """Runs body() under torch.profiler and keeps its reduction."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device != "cpu":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            self.sync()
            t = time.perf_counter()
            body()
            self.sync()
            t = time.perf_counter() - t
        self.record["trace"] = tr.reduce_profile(prof.events(), steps)
        self.record["trace"]["window_s"] = t

    def peak(self):
        if self.device != "cpu":
            self.record["peak_bytes"] = torch.cuda.max_memory_allocated()

    def for_reference(self):
        """After the program's state is dropped: free its memory, and run
        float32 products in float32 (no TF32) from here on."""
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def run_train(r):
    from monodetr_torch.models.criterion import SetCriterion
    from monodetr_torch.models.monodetr import compute_dtype
    from monodetr_torch.train.optimizer import build_optimizer
    from monodetr_torch.train.train_step import make_train_step

    cfg, mix = r.config["model"], r.mix
    model = r.program_model()
    opt = build_optimizer(r.config["optimizer"], model)
    criterion = SetCriterion(cfg)
    step = make_train_step(model, criterion, opt, compute_dtype(cfg))
    # the checked steps' assignments, as the program's matcher returns them,
    # and the proposal picks of a program that picks them
    assigned, picks = [], []
    matcher = criterion.match

    def match(outputs, targets, train=True):
        matched = matcher(outputs, targets, train)
        assigned.append(ref_steps.assignment(matched, targets["mask"]))
        if "proposal_idx" in outputs:
            picks.append(outputs["proposal_idx"].cpu())
        return matched

    criterion.match = match
    pool = r.traffic.batches(r.device)
    gen = torch.Generator(r.device).manual_seed(r.seeds[3])
    lr, n = mix["lr"], len(pool)
    checked = r.config["reference"].get("steps", mix["checked_steps"])
    params = dict(model.named_parameters())
    start = {k: v.detach().clone() for k, v in params.items()}
    prog = {"losses": [], "terms": [], "picks": picks}
    for i in range(checked):
        terms = {k: float(v) for k, v in step(pool[i % n], lr, gen).as_dict().items()}
        prog["losses"].append(terms["loss_detr"])
        prog["terms"].append(terms)
        if i == 0:
            prog["grad"] = {k: float(m.double().norm()) / (1 - ADAM_B1)
                            for k, m in opt.state_dict()["m"].items()}
    prog["change"] = {k: float((params[k].detach() - start[k]).double().norm())
                      for k in prog["grad"]}
    del start, criterion.match
    at = checked
    for _ in range(mix["checked_steps"] - checked + mix["warmup_steps"]):
        step(pool[at % n], lr, gen)
        at += 1
    r.sync()
    r.record["setup_s"] = time.perf_counter() - r.t0

    host = 0.0
    steps = 0
    ends = []
    t_start = time.perf_counter()
    while True:
        h0 = time.perf_counter()
        step(pool[at % n], lr, gen)
        h1 = time.perf_counter()
        host += h1 - h0
        ends.append(h1 - t_start)
        at += 1
        steps += 1
        if h1 - t_start >= r.seconds:
            break
    r.sync()
    window = time.perf_counter() - t_start
    r.record["window"] = {"seconds": window, "steps": steps, "images": steps * mix["batch"],
                          "host_s": host, "ends_s": ends}
    if r.traced:
        def body():
            nonlocal at
            for _ in range(mix["profiled_steps"]):
                step(pool[at % n], lr, gen)
                at += 1
        r.profiled(body, mix["profiled_steps"])
    r.peak()

    del model, opt, step, pool, params, gen
    r.for_reference()
    t_ref = time.perf_counter()
    batches = r.traffic.batches(r.device)[:checked]
    ref = ref_steps.train_steps(
        r.arch, cfg, r.state(), batches, r.seeds[3], lr, r.config["optimizer"]["weight_decay"],
        r.config["reference"]["micro_batch"], r.device, given=assigned,
        given_picks=picks or None)
    numbers, worst = check.train_numbers(prog, ref)
    r.record["worst_leaf"] = worst
    r.record["numbers"] = numbers
    r.record["term_gaps"] = [
        sorted(((abs(p[k] - q[k]) / max(abs(q[k]), 1e-12), k) for k in q), reverse=True)[:4]
        for p, q in zip(prog["terms"], ref["terms"])]
    r.record["reference_s"] = time.perf_counter() - t_ref
    return numbers


def _sample(r, n_frames):
    rng = np.random.default_rng(r.seeds[4])
    return set(rng.choice(n_frames, size=min(r.mix["check_frames"], n_frames),
                          replace=False).tolist())


def _infer(r, serve_batches):
    """The inference loop's set-up, warm-up, the window, the trace,
    and the check of the sampled frames.  serve_batches(model, frames,
    keep) -> a generator that serves one batch a step and yields (images,
    host seconds, latencies [s]); `keep(infos, dets, rows)` stores what a
    sampled frame got."""
    mix = r.mix
    model = r.program_model()
    frames = r.traffic.frames(r.device)
    B = mix["batch"]
    sample = _sample(r, B * len(frames))
    served, served_rows = [], []
    recording = [False]

    counted = [0]

    def keep(infos, dets, rows):
        if recording[0]:
            counted[0] += sum(len(rows[i["img_id"]]) for i in infos)
            for j, info in enumerate(infos):
                if info["img_id"] in sample:
                    served.append((info["img_id"], dets[j]))
                    served_rows.append((info["img_id"], rows[info["img_id"]]))

    with r.autocast():
        serving = serve_batches(model, frames, keep)
        for _ in range(mix["warmup_batches"]):
            next(serving)
        r.sync()
        r.record["setup_s"] = time.perf_counter() - r.t0
        recording[0] = True
        images, batches, host, lat, ends = 0, 0, 0.0, [], []
        t_start = time.perf_counter()
        while True:
            n, h, ls = next(serving)
            images += n
            batches += 1
            host += h
            lat.extend(ls)
            ends.append(time.perf_counter() - t_start)
            if ends[-1] >= r.seconds:
                break
        r.sync()
        window = time.perf_counter() - t_start
        recording[0] = False
        r.record["rows_per_frame"] = counted[0] / max(images, 1)
        r.record["window"] = {"seconds": window, "steps": batches,
                              "images": images, "host_s": host, "latencies_s": lat,
                              "ends_s": ends}
        if r.traced:
            def body():
                for _ in range(mix["profiled_batches"]):
                    next(serving)
            r.profiled(body, mix["profiled_batches"])
        serving.close()
    r.peak()

    del model
    r.for_reference()
    t_ref = time.perf_counter()
    ids = sorted(sample)
    allimg = np.concatenate([f[0]["images"] for f in frames])
    calibs = np.concatenate([f[0]["calibs"] for f in frames])
    sizes = np.concatenate([f[0]["img_sizes"] for f in frames])
    cands = ref_steps.candidates(
        r.arch, r.config["model"], r.state(), torch.from_numpy(allimg[ids]),
        torch.from_numpy(calibs[ids]), torch.from_numpy(sizes[ids]), r.device)
    cands = dict(zip(ids, cands))
    numbers = check.det_numbers(served, cands, mix["topk"])
    mean = np.zeros((3, 3))
    row_gap = check.row_numbers(
        served_rows, served, lambda det, i: ref_steps.decode(det, calibs[i], sizes[i], mean),
        mix["threshold"])
    numbers["row_gap"] = row_gap
    r.record["served_checked"] = len(served)
    r.record["numbers"] = numbers
    r.record["reference_s"] = time.perf_counter() - t_ref
    return numbers


def _decode(batch, infos, dets, threshold):
    from monodetr_torch.data.kitti_utils import Calibration
    from monodetr_torch.eval.decode import decode_detections

    info = {"img_id": [i["img_id"] for i in infos], "img_size": [i["img_size"] for i in infos]}
    calibs = [Calibration.from_p2(batch["calibs"][i]) for i in range(len(infos))]
    return decode_detections(dets, info, calibs, np.zeros((3, 3), np.float32), threshold)


def run_stream(r):
    from monodetr_torch.train.train_step import batch_to_device, make_eval_step

    keys = ("images", "calibs", "img_sizes")
    mix = r.mix

    def serve(model, frames, keep):
        eval_step = make_eval_step(model, topk=mix["topk"])
        order = np.random.default_rng(r.seeds[1]).permutation(len(frames))
        at = 0
        while True:
            batch, infos = frames[order[at % len(order)]]
            at += 1
            t0 = time.perf_counter()
            on_card = batch_to_device(batch, r.device, keys)
            out = eval_step(*(on_card[k] for k in keys))
            t1 = time.perf_counter()
            dets = out.cpu().numpy()
            t2 = time.perf_counter()
            rows = _decode(batch, infos, dets, mix["threshold"])
            t3 = time.perf_counter()
            keep(infos, dets, rows)
            yield len(infos), (t1 - t0) + (t3 - t2), [t3 - t0]

    return _infer(r, serve)


LOOPS = {"train": run_train, "stream": run_stream}


def run(config, mix, limits, seed, seconds, traced, device, t0):
    """(record, correct, {name: {value, limit}}) of one run of a cell."""
    r = Run(config, mix, seed, seconds, traced, device, t0)
    numbers = LOOPS[mix["kind"]](r)
    r.record["class_bias"] = r.bias
    correct, shown = check.verdict(numbers, limits["limits"])
    return r.record, correct, shown
