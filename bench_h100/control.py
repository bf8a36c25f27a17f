"""The control and the faults of a cell's output check, which its limits
must fail.  The benchmark's own runs do not run this.

    python3 bench_h100/control.py --workload <cell> --seeds 11,12,13 [--fault <name>]

Without --fault: the precision control, the reference put in the program's
place and computed in the precision below the configuration's (bf16 ->
fp8 e4m3, each product's operands rounded with one scale per tensor), held
to the float32 reference by the same numbers as the program (inference
cells serve the control's own top-k detections and their decoded rows).
With --fault: a run of the cell as the benchmark makes it (a 3-second
window), with the fault of core/faults.py planted in the program; with
--fault none, the same run of the sound program, whose numbers are the
lower readings of the limits.

Prints one JSON line per seed with every number and the verdict of the
cell's limits on them (`correct`).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_control(config, mix, seed, device):
    from bench_h100.core import check
    from bench_h100.core.loops import Run
    from bench_h100.reference import steps
    from bench_h100.reference.model import Fp8

    r = Run(config, mix, seed, 0, False, device, 0.0)
    r.for_reference()
    batches = r.traffic.batches(device)[:mix["checked_steps"]]
    args = (r.arch, config["model"], r.state(), batches, r.seeds[3], mix["lr"],
            config["optimizer"]["weight_decay"], config["reference"]["micro_batch"], device)
    low = steps.train_steps(*args, prec=Fp8())
    ref = steps.train_steps(*args, given=low["assignment"], given_picks=low.get("picks"))
    return check.train_numbers(low, ref)


def infer_control(config, mix, seed, device):
    import numpy as np
    import torch

    from bench_h100.core import check
    from bench_h100.core.loops import Run, _sample
    from bench_h100.reference import steps
    from bench_h100.reference.model import Fp8

    r = Run(config, mix, seed, 0, False, device, 0.0)
    r.for_reference()
    frames = r.traffic.frames(device)
    ids = sorted(_sample(r, mix["batch"] * len(frames)))
    images = np.concatenate([f[0]["images"] for f in frames])[ids]
    calibs = np.concatenate([f[0]["calibs"] for f in frames])[ids]
    sizes = np.concatenate([f[0]["img_sizes"] for f in frames])[ids]
    args = (r.arch, config["model"], r.state(), torch.from_numpy(images),
            torch.from_numpy(calibs), torch.from_numpy(sizes), device)
    low = steps.candidates(*args, prec=Fp8())
    ref = dict(zip(ids, steps.candidates(*args)))
    mean = np.zeros((3, 3))
    served, rows = [], []
    for k, i in enumerate(ids):
        dets = low[k][np.argsort(-low[k][:, 1], kind="stable")[:mix["topk"]]]
        served.append((i, dets))
        rows.append((i, [steps.decode(d, calibs[k], sizes[k], mean) for d in dets
                         if d[1] >= mix["threshold"]]))
    numbers = check.det_numbers(served, ref, mix["topk"])
    pos = {i: k for k, i in enumerate(ids)}
    numbers["row_gap"] = check.row_numbers(
        rows, served, lambda d, i: steps.decode(d, calibs[pos[i]], sizes[pos[i]], mean),
        mix["threshold"])
    return numbers, None


def fault_run(config, mix, seed, fault, device):
    import contextlib
    import time

    from bench_h100.core import faults, loops

    planted = (contextlib.nullcontext() if fault == "none"
               else faults.planted(mix["kind"], fault)())
    with planted:
        record, _, _ = loops.run(config, mix, {"limits": {}}, seed, 3.0, False, device,
                                 time.perf_counter())
    return record["numbers"], record.get("worst_leaf")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from bench_h100.core import check, spec

    _, config, mix, limits, _, _ = spec.cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fault:
            numbers, extra = fault_run(config, mix, seed, args.fault, args.device)
        else:
            run = train_control if mix["kind"] == "train" else infer_control
            numbers, extra = run(config, mix, seed, args.device)
        correct, _ = check.verdict(numbers, limits["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.fault or "fp8", "correct": correct,
                          "numbers": numbers, "extra": extra}), flush=True)


if __name__ == "__main__":
    main()
