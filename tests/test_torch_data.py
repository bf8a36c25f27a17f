"""The port imports nothing of the JAX package, and its copies of the data
pipeline and the KITTI evaluator compute what the originals do.

An AST walk over every module of monodetr_torch, chip_smoke.py,
bench_torch.py and the port's tools (tools/*_torch.py: the CLI and the
validation tools, which of the tests take only tests/synthetic_kitti.py,
itself numpy and PIL) refuses any import of jax, flax, monodetr_tpu or
the JAX side's modules at the repo's root (bench.py, __graft_entry__.py),
any path built from the string "monodetr_tpu" (a `file.py:line` citation
of a counterpart, as in a docstring, is fine), and any load by path (importlib's
spec_from_file_location and SourceFileLoader, runpy.run_path, ctypes'
CDLL and LoadLibrary) of a file that is not the port's own: a path named
by its strings must be one of monodetr_torch/** or tools/*_torch.py, or
come from monodetr_torch/_build.py's build functions (build/).  The port's KITTIDataset gives the
JAX package's arrays for the same numpy seed, with augmentation on (train)
and off (val), and its DataLoader the same batches.  The decode's
calibration loads without the dataset's image libraries."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from monodetr_torch.data import KITTIDataset as TorchKITTIDataset
from monodetr_torch.data.loader import DataLoader as TorchDataLoader
from monodetr_tpu.data import KITTIDataset as JaxKITTIDataset
from monodetr_tpu.data.loader import DataLoader as JaxDataLoader
from tests.synthetic_kitti import make_synthetic_kitti

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# jax, flax, the JAX package and the JAX side's modules at the repo's root
FORBIDDEN = ("jax", "flax", "monodetr_tpu", "bench", "__graft_entry__")
# a citation of the counterpart, e.g. "monodetr_tpu/ops/attention_pallas.py:162"
CITATION = re.compile(r"^monodetr_tpu(/\w+)+\.py:\d+$")


def port_files():
    tools = os.path.join(REPO, "tools")
    files = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "bench_torch.py")]
    files += [os.path.join(tools, n) for n in sorted(os.listdir(tools)) if n.endswith("_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO, "monodetr_torch")):
        files += [os.path.join(root, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(files)


def _forbidden(module):
    return module is not None and module.split(".")[0] in FORBIDDEN


def _docstrings(tree):
    """The ids of the docstring constants of the module, classes and functions."""
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                ids.add(id(body[0].value))
    return ids


def jax_package_uses(source):
    """(line, what) for every import of jax, flax or monodetr_tpu, every
    import by name (importlib.import_module, __import__) of one of them, and
    every string naming monodetr_tpu that is neither a docstring nor a
    `file.py:line` citation."""
    tree = ast.parse(source)
    seen = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, "import " + a.name) for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and _forbidden(node.module):
                found.append((node.lineno, "from " + node.module))
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
                        and _forbidden(arg.value):
                    found.append((node.lineno, f"{name}({arg.value!r})"))
                    seen.add(id(arg))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if "monodetr_tpu" in node.value and id(node) not in seen \
                    and not CITATION.match(node.value):
                found.append((node.lineno, repr(node.value)))
    return found


# loaders by path -> the index of their path argument
BY_PATH = {"spec_from_file_location": 1, "SourceFileLoader": 1, "run_path": 0, "CDLL": 0,
           "PyDLL": 0, "LoadLibrary": 0, "load_library": 0}
# the port's own files, as the strings of a path spell them
PORT_PATH = re.compile(r"(^|/)(monodetr_torch(/\w+)*/\w+\.py|tools/\w+_torch\.py)$")
# monodetr_torch/_build.py's functions that return what it built under build/
BUILD_FUNCTIONS = ("build", "build_host")


def _call_name(node):
    fn = node.func
    return fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")


def _path_parts(expr, assigned, depth=0):
    """The string constants of a path expression and the names of the
    functions it calls, following names to what the module assigns them
    (a few levels deep)."""
    strings, calls = [], set()
    nodes = [n for n in ast.walk(expr) if hasattr(n, "lineno")]
    for node in sorted(nodes, key=lambda n: (n.lineno, n.col_offset)):  # source order
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            strings.append(node.value)
        elif isinstance(node, ast.Call):
            calls.add(_call_name(node))
        elif isinstance(node, ast.Name) and node.id in assigned and depth < 4:
            for value in assigned[node.id]:
                s, c = _path_parts(value, assigned, depth + 1)
                strings += s
                calls |= c
    return strings, calls


def by_path_loads(source):
    """(line, what) for every load by path whose path is not the port's
    own: its strings, joined by "/", must spell a port file, or it must
    come from one of _build.py's BUILD_FUNCTIONS."""
    tree = ast.parse(source)
    assigned = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    assigned.setdefault(target.id, []).append(node.value)
    found = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or _call_name(node) not in BY_PATH:
            continue
        i = BY_PATH[_call_name(node)]
        args = list(node.args) + [k.value for k in node.keywords]
        if len(args) <= i:
            found.append((node.lineno, f"{_call_name(node)} without a path"))
            continue
        strings, calls = _path_parts(args[i], assigned)
        path = "/".join(x.strip("/") for x in strings if x.strip("/"))
        if not (PORT_PATH.search(path) or calls & set(BUILD_FUNCTIONS)):
            found.append((node.lineno, f"{_call_name(node)}({path or '?'})"))
    return found


@pytest.mark.parametrize("path", port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_uses_nothing_of_the_jax_package(path):
    with open(path) as f:
        source = f.read()
    assert jax_package_uses(source) == []
    assert by_path_loads(source) == []


@pytest.mark.parametrize("source", [
    "import importlib.util, os\n"
    "spec = importlib.util.spec_from_file_location(\n"
    "    'm', os.path.join(os.path.dirname(__file__), '..', 'tools', 'convert_checkpoint.py'))",
    "import importlib.util\nfrom pathlib import Path\n"
    "_CONVERTER = Path(__file__).resolve().parents[2] / 'tools' / 'convert_checkpoint.py'\n"
    "spec = importlib.util.spec_from_file_location('m', _CONVERTER)",
    "import ctypes, os\n"
    "lib = ctypes.CDLL(os.path.join(os.path.dirname(__file__), '..', 'native', "
    "'libkitti_native.so'))",
    "import ctypes\n_LIB_PATH = 'native/libkitti_native.so'\nlib = ctypes.cdll.LoadLibrary(_LIB_PATH)",
    "import runpy\nrunpy.run_path('tools/train_val.py', run_name='__main__')",
    "from importlib.machinery import SourceFileLoader\n"
    "m = SourceFileLoader('m', 'monodetr_tpu/native.py').load_module()",
    "import ctypes\ndef load(path):\n    return ctypes.CDLL(path)",
])
def test_the_walk_finds_a_load_by_path(source):
    assert len(by_path_loads(source)) == 1


def test_the_walk_passes_the_ports_own_loads():
    source = ("import ctypes, os, runpy\n"
              "lib = ctypes.CDLL(str(build()))\n"
              "host = ctypes.CDLL(str(_build.build_host()))\n"
              "tool = os.path.join(REPO, 'tools', 'train_val_torch.py')\n"
              "runpy.run_path(tool, run_name='__main__')\n"
              "runpy.run_path(os.path.join(REPO, 'monodetr_torch', 'parallel', 'dryrun.py'))\n")
    assert by_path_loads(source) == []


@pytest.mark.parametrize("source", [
    "import jax",
    "import jax.numpy as jnp",
    "from flax import linen",
    "import monodetr_tpu.native",
    "from monodetr_tpu.data import KITTIDataset",
    "import importlib\nm = importlib.import_module('monodetr_tpu.config')",
    "m = __import__('jax')",
    "import bench",
    "from bench import bench_env",
    "import __graft_entry__",
    "from pathlib import Path\nd = Path(__file__).parents[2] / 'monodetr_tpu'",
    "import os\nd = os.path.join(os.path.dirname(__file__), '..', 'monodetr_tpu', 'native.py')",
])
def test_the_walk_finds_a_jax_package_use(source):
    assert len(jax_package_uses(source)) == 1


def test_the_walk_passes_docstrings_and_citations():
    source = ('"""Counterpart of monodetr_tpu/ops/attention_pallas.py."""\n'
              'def f():\n    """monodetr_tpu/native.py, copied."""\n'
              'SPEC = dict(replaces="monodetr_tpu/ops/lap_pallas.py:148")\n'
              'from . import native\nfrom .data import loader\n'
              'from monodetr_torch.bench import main\nfrom .bench import bench_env\n'
              'import bench_loader_torch\n')
    assert jax_package_uses(source) == []


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return make_synthetic_kitti(str(tmp_path_factory.mktemp("kitti")), n_train=4, n_val=2,
                                seed=11)


def dataset_cfg(root, augment):
    cfg = {"root_dir": root, "writelist": ["Car"], "resolution": [320, 128]}
    if augment:
        cfg.update(aug_pd=True, aug_crop=True, random_flip=0.5, random_crop=0.5, scale=0.4,
                   shift=0.1)
    else:
        cfg.update(random_flip=0.0, random_crop=0.0)
    return cfg


def assert_same(a, b, where):
    assert type(a).__name__ == type(b).__name__, where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        assert_same(vars(a), vars(b), where)
    else:
        assert a == b, where


@pytest.mark.parametrize("split,augment", [("train", True), ("train", False), ("val", False)])
def test_dataset_items_match_the_jax_package(kitti_root, split, augment):
    port = TorchKITTIDataset(split, dataset_cfg(kitti_root, augment))
    ref = JaxKITTIDataset(split, dataset_cfg(kitti_root, augment))
    assert len(port) == len(ref) > 0
    for i in range(len(port)):
        for seed in (0, 1, 2):
            np.random.seed(seed)
            got = port[i]
            np.random.seed(seed)
            want = ref[i]
            assert_same(got, want, f"{split}[{i}] seed {seed}")


def test_loader_batches_match_the_jax_package(kitti_root):
    cfg = dataset_cfg(kitti_root, False)
    port = TorchDataLoader(TorchKITTIDataset("train", cfg), batch_size=3, shuffle=True,
                           num_workers=1, seed=5)
    ref = JaxDataLoader(JaxKITTIDataset("train", cfg), batch_size=3, shuffle=True,
                        num_workers=1, seed=5)
    port.set_epoch(2)
    ref.set_epoch(2)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 2
    for (bg, ig), (bw, iw) in zip(got, want):
        assert_same(bg, bw, "batch")
        assert_same(ig, iw, "infos")


def test_calibration_loads_without_the_image_libraries():
    """The Tester's decode imports data.kitti_utils; the data package loads
    its dataset (PIL, cv2) only when KITTIDataset or build_dataloader is
    asked for."""
    code = ("import sys; from monodetr_torch.data.kitti_utils import Calibration; "
            "print(sorted(m for m in ('PIL', 'cv2', 'monodetr_torch.data.kitti_dataset') "
            "if m in sys.modules)); import monodetr_torch.data as d; "
            "print(d.KITTIDataset.__module__, d.build_dataloader.__module__)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines() == [
        "[]", "monodetr_torch.data.kitti_dataset monodetr_torch.data.loader"]
