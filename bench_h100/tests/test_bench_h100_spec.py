"""BENCHMARK.json and the files it names: the allowed characters and keys,
every cell's files found by name, a mix and a reference model added
without editing a file, and what the benchmark's modules may import."""

import ast
import filecmp
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

from bench_h100.core import counts, spec, weights

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "bench_h100"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_per_layer_cells_report_what_they_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for cell in cells:
        assert sum(cell in ws for ws in e2e.values()) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_every_cell_and_metric_found_by_name(bench):
    for w in bench["workloads"]:
        work, config, mix, limits, e2e, per_layer = spec.cell(w["name"], REPO)
        assert config["name"] == w["config"] and mix["kind"] in ("train", "stream")
        assert limits["limits"]
        for m in e2e + per_layer:
            assert callable(spec.reader(m["name"], BENCH))
    for c in bench["configs"]:
        assert c["file"].startswith("bench_h100/") and (REPO / c["file"]).is_file()


def test_a_mix_added_without_editing_any_file(tmp_path, bench):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench_h100", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "bench_h100" / "mixes" / "train_bs8.json").write_text(json.dumps(
        dict(spec.load_mix("train_bs16"), batch=8)))
    (root / "bench_h100" / "limits" / "r50.train_bs8.json").write_text(
        (BENCH / "limits" / "r50.train_bs16.json").read_text())
    added = dict(bench, workloads=bench["workloads"] + [
        {"name": "r50.train_bs8", "config": "monodetr_r50_384x1280", "traffic": "train_bs8",
         "chips": 1, "why": "a smaller batch"}])
    (root / "BENCHMARK.json").write_text(json.dumps(added))
    _, config, mix, _, e2e, _ = spec.cell("r50.train_bs8", root)
    assert mix["batch"] == 8 and config["name"] == "monodetr_r50_384x1280"
    assert [m["name"] for m in e2e] == ["setup_s"]


PROBE = '''"""The standard model with one more leaf, drawn at scale 1, and one
more product in its forward."""
import torch
from torch import nn

from . import model
from .model import trained  # noqa: F401

EMBEDDINGS = ("probe.weight",)


class MonoDETR(model.MonoDETR):
    def add_queries(self, m):
        super().add_queries(m)
        self.probe = nn.Embedding(4, m["hidden_dim"])

    def forward(self, *args):
        outs, logits, proposals = super().forward(*args)
        w = self.probe.weight
        outs[-1]["pred_logits"] = outs[-1]["pred_logits"] + (w @ w.T).sum()
        return outs, logits, proposals


def build(model_cfg, device="cpu"):
    return model.build(model_cfg, device, MonoDETR)
'''


def test_a_reference_added_without_editing_any_file(tmp_path, bench):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench_h100", ignore=shutil.ignore_patterns("__pycache__"))
    new = root / "bench_h100"
    (new / "reference" / "probe.py").write_text(PROBE)
    config = json.loads((BENCH / "configs" / "monodetr_r50_384x1280.json").read_text())
    config.update(name="monodetr_probe", input={"height": 64, "width": 128})
    config["reference"]["model"] = "probe"
    (new / "configs" / "monodetr_probe.json").write_text(json.dumps(config))
    (new / "limits" / "probe.train_bs16.json").write_text(
        (BENCH / "limits" / "r50.train_bs16.json").read_text())
    entry = dict(bench["configs"][0], name="monodetr_probe",
                 file="bench_h100/configs/monodetr_probe.json")
    added = dict(bench, configs=bench["configs"] + [entry], workloads=bench["workloads"] + [
        {"name": "probe.train_bs16", "config": "monodetr_probe", "traffic": "train_bs16",
         "chips": 1, "why": "a reference model of its own"}])
    (root / "BENCHMARK.json").write_text(json.dumps(added))
    try:
        _, config, _, _, _, _ = spec.cell("probe.train_bs16", root)
        arch = spec.reference(config)
        assert arch.__file__ == str(new / "reference" / "probe.py")
        state = weights.make_state(arch, 11, config, "cpu")
        assert 0.5 < float(state["probe.weight"].std()) < 2.0  # drawn at scale 1
        standard = dict(config, reference={"micro_batch": 1})
        got, base = counts.frozen_counts(config), counts.frozen_counts(standard)
        # w @ w.T of [4, 256]: 2 * 4 * 256 * 4 products forward, twice that backward
        assert got["eval_flops_per_img"] - base["eval_flops_per_img"] == 8192
        assert got["train_flops_per_img"] - base["train_flops_per_img"] == 3 * 8192
    finally:
        sys.modules.pop("bench_h100.reference.probe", None)
    added_files = {Path("reference/probe.py"), Path("configs/monodetr_probe.json"),
                   Path("limits/probe.train_bs16.json")}
    for path in new.rglob("*"):
        rel = path.relative_to(new)
        if path.is_file() and "__pycache__" not in rel.parts and rel not in added_files:
            assert filecmp.cmp(path, BENCH / rel, shallow=False), rel
    assert spec.reference(spec.load_config("monodetr_r50_384x1280")).__file__ == str(
        BENCH / "reference" / "model.py")


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_imports():
    """No module of the benchmark imports the JAX side or bench.py, and the
    reference imports nothing of the program; top-level names compared
    whole (monodetr_torch begins with the letters of monodetr_tpu)."""
    sources = sorted(BENCH.rglob("*.py"))
    assert sources
    for path in sources:
        names = _top_level_imports(path)
        assert not names & {"jax", "jaxlib", "flax", "monodetr_tpu", "bench"}, path
        if "reference" in path.parts:
            assert "monodetr_torch" not in names and "bench_h100" not in names, path
    assert "monodetr_torch" in _top_level_imports(BENCH / "run.py") | set().union(
        *(_top_level_imports(p) for p in (BENCH / "core").glob("*.py")))
