"""The benchmark of monodetr_torch on one H100: runs one cell once.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up builds the program's model with
weights made from the seed on the card, makes the cell's traffic, warms up
every shape the cell uses, and then measures for `--seconds` seconds.
With --trace 0 the last line of standard output is the cell's end-to-end
metrics, with --trace 1 its per-layer metrics (a profiled stretch follows
the window).  Either way the program's output on the timed path is then
held to the reference (`correct`), each number beside its limit, as the
last lines of standard error and under the last key of the result line.

Exits non-zero without printing a result when there is no CUDA card, when
the program cannot be imported, or when jax, jaxlib, flax or the JAX
package is loaded once the window has closed.
"""

import argparse
import json
import math
import os
import sys
import time

T0 = time.perf_counter()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "monodetr_tpu")


def fail(msg):
    print(f"bench_h100: {msg}", file=sys.stderr)
    sys.exit(1)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def number(v):
    return v if math.isfinite(v) else 1e308


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program or its libraries write stays in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", "bench_h100_cache", sub))
    os.environ.setdefault("USE_FLAX", "0")
    # one process, few threads: the program's host work is one Python thread
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    sys.path.insert(0, ROOT)

    import torch

    from bench_h100.core import loops, spec

    work, config, mix, limits, e2e, per_layer = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        fail(f"needs {work['chips']} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import monodetr_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program under test does not import: {e}")

    record, correct, shown = loops.run(config, mix, limits, args.seed, args.seconds,
                                       bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        fail(f"modules of the JAX side are loaded: {', '.join(found)}")

    wanted = per_layer if args.trace else e2e
    metrics = {}
    for entry in wanted:
        value = spec.reader(entry["name"], os.path.join(ROOT, "bench_h100"))(record)
        if value is None:
            print(f"bench_h100: {entry['name']} found nothing to read", file=sys.stderr)
            continue
        metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": int(record["peak_bytes"])}
    result = {"correct": bool(correct), "attempted": record["window"]["images"],
              "failed": 0, "metrics": metrics, "device": device}
    if args.trace:
        from bench_h100.core import trace

        ops = record["trace"]["ops"]
        device["busy_s"] = trace.busy_us(ops) * 1e-6
        device["window_s"] = record["trace"]["window_s"]
        groups = trace.by_group(ops)
        result["breakdown"] = {
            "device_ops": [[g, ms * 1e-3] for g, ms in
                           sorted(groups.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[name, s] for name, s in record["trace"]["gaps"]],
        }
    result["check"] = {k: {"value": number(v["value"]), "limit": v["limit"]}
                       for k, v in shown.items()}
    print(json.dumps(result))
    sys.stdout.flush()
    w = record["window"]
    tenths = [sum(1 for e in w["ends_s"] if k * w["seconds"] / 10 <= e < (k + 1) * w["seconds"]
                  / 10) for k in range(10)]
    print(f"bench_h100: set-up {record['setup_s']:.3f} s; window {w['seconds']:.3f} s, "
          f"{w['steps']} steps, {w['images']} images, host {w['host_s']:.3f} s, steps by "
          f"tenth {tenths}; of the set-up, the class-bias calibration "
          f"{record['calibration_s']:.3f} s; reference {record['reference_s']:.3f} s; peak "
          f"{record['peak_bytes']} B; worst leaf {record.get('worst_leaf')}; rows decoded per "
          f"frame {record.get('rows_per_frame')}; class bias {record.get('class_bias')}",
          file=sys.stderr)
    print(f"bench_h100: numbers {json.dumps(record['numbers'])}; loss terms of largest gap "
          f"per step {record.get('term_gaps')}", file=sys.stderr)
    for k, v in shown.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"check correct {correct}", file=sys.stderr)


if __name__ == "__main__":
    main()
