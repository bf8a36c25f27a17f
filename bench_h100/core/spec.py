"""Finds what a cell names, by name: the cell's entry in BENCHMARK.json,
its configuration file, the configuration's reference module
(`reference/<model>.py`, the configuration's `reference.model`, by default
`model`), its traffic mix (`mixes/<traffic>.json`), the limits of its
output check (`limits/<cell>.json`) and a metric's reader
(`metrics/<metric>.py`, exporting `read(record)`).  Nothing here knows a
cell, a configuration, a reference, a mix or a metric by name."""

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent


def benchmark(root=REPO):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _read(path):
    with open(path) as f:
        return json.load(f)


def load_config(name, root=REPO):
    entry = next(c for c in benchmark(root)["configs"] if c["name"] == name)
    return _read(Path(root) / entry["file"])


def reference(config, bench_dir=BENCH_DIR):
    """The reference module that `config` names, bench_h100.reference.<model>
    (exporting `build(model_cfg, device)`, `trained(name)` and, where it
    draws more leaves at scale 1 than the standard model, `EMBEDDINGS`).
    The first call for a name imports reference/<model>.py of `bench_dir`;
    every later call, from any module of the run, gets that module."""
    name = config.get("reference", {}).get("model", "model")
    full = f"bench_h100.reference.{name}"
    if full not in sys.modules:
        path = Path(bench_dir) / "reference" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(full, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[full] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[full]
            raise
    return sys.modules[full]


def load_mix(name, bench_dir=BENCH_DIR):
    return _read(Path(bench_dir) / "mixes" / f"{name}.json")


def load_limits(cell, bench_dir=BENCH_DIR):
    return _read(Path(bench_dir) / "limits" / f"{cell}.json")


def reader(metric, bench_dir=BENCH_DIR):
    """The `read(record)` function of metrics/<metric>.py."""
    path = Path(bench_dir) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_h100_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell(name, root=REPO):
    """(workload entry, configuration, mix, limits, end-to-end metric
    entries, per-layer metric entries) of a cell; the configuration's
    reference module is imported from the checkout at `root`."""
    bench = benchmark(root)
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    bench_dir = Path(root) / bench["paths"][0]
    config = load_config(work["config"], root)
    reference(config, bench_dir)
    mix = load_mix(work["traffic"], bench_dir)
    limits = load_limits(name, bench_dir)

    e2e = [e for e in bench["end_to_end"] if name in e.get("workloads", [name])]
    moved = {e["name"] for e in e2e}
    # a per-layer metric without `workloads` is reported wherever what it moves is
    per_layer = [e for e in bench["per_layer"]
                 if name in e.get("workloads", [name] if e["moves"] in moved else [])]
    return work, config, mix, limits, e2e, per_layer
