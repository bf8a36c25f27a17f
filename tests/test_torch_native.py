"""The port's host kernels (monodetr_torch/native.py over
csrc/kitti_native.cpp, built by _build.build_host) against their plain
versions and against the JAX package's native library, and the build's
own rules.

Mirrors tests/test_native.py and tests/test_native_match.py with their
tolerances: the warp against PIL (PIL rounds the warped image to uint8
and treats border samples differently: the interior within 1.5 uint8
steps at most and half a step on average), the identity warp to 1e-5,
the rotated IoU against the numpy clip to 1e-4, the matching equal to
the numpy matcher (similarity and scores to rtol 1e-9), and the whole
official evaluation native against plain to rtol 1e-9.  The port's
library and monodetr_tpu.native compile one source under the same flags,
so their outputs must be bit-equal.  A changed source or flag builds into
a new directory; a failed build raises with the compiler's output and
never leaves the caller on a Python path.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from monodetr_torch import _build, native
from monodetr_torch.data.kitti_dataset import warp_plain
from monodetr_torch.data.kitti_utils import get_affine_transform
from monodetr_torch.eval.kitti_eval import eval as ev
from monodetr_torch.eval.kitti_eval.rotated_iou import (
    rotate_iou_eval, rotate_iou_eval_plain, rotated_box_intersection)
from tests.test_kitti_eval import make_annos, random_case

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kitti_image(seed):
    src = np.random.RandomState(seed).randint(0, 255, (375, 1242, 3)).astype(np.uint8)
    # smooth the noise so bilinear sub-pixel differences are tiny
    return (src.astype(np.float32) + np.roll(src, 1, 0) + np.roll(src, 1, 1)).astype(np.uint8)


def crop_transform(scale=1.04, center=(640.0, 190.0), res=(320, 96)):
    _, trans_inv = get_affine_transform(np.array(center), np.array([1242 * scale, 375 * scale]),
                                        0, np.array(res), inv=1)
    return trans_inv


def random_boxes(seed):
    rng = np.random.RandomState(seed)
    boxes = np.stack([rng.uniform(-10, 10, 40), rng.uniform(0, 60, 40), rng.uniform(1, 5, 40),
                      rng.uniform(1, 3, 40), rng.uniform(-np.pi, np.pi, 40)], -1)
    return boxes, boxes[:25] + rng.randn(25, 5) * 0.3


def test_warp_matches_the_plain_version():
    src, inv = kitti_image(0), crop_transform()
    want = warp_plain(Image.fromarray(src), inv, (320, 96), MEAN, STD)
    got = native.warp_affine_normalize(src, inv, 320, 96, MEAN, STD)
    assert got.shape == want.shape == (96, 320, 3) and got.dtype == np.float32
    tol = (1.0 / 255.0) / STD.min() + 1e-4
    diff = np.abs(got - want)[4:-4, 4:-4]
    assert diff.max() < tol * 1.5, diff.max()
    assert diff.mean() < tol * 0.5, diff.mean()


def test_warp_identity_transform():
    src = np.random.RandomState(1).randint(0, 255, (96, 320, 3)).astype(np.uint8)
    inv = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    got = native.warp_affine_normalize(src, inv, 320, 96, MEAN, STD)
    np.testing.assert_allclose(got, (src.astype(np.float32) / 255.0 - MEAN) / STD, atol=1e-5)
    # the same identity through PIL: only its uint8 rounding differs, and
    # identity sampling rounds nothing
    np.testing.assert_allclose(got, warp_plain(Image.fromarray(src), inv, (320, 96), MEAN, STD),
                               atol=1e-5)


def test_warp_refuses_a_bad_image():
    with pytest.raises(ValueError):
        native.warp_affine_normalize(np.zeros((8, 8), np.uint8), np.eye(2, 3), 4, 4, MEAN, STD)


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotated_iou_matches_the_plain_version(criterion):
    boxes, qboxes = random_boxes(2)
    want = rotate_iou_eval_plain(boxes, qboxes, criterion)
    got = rotate_iou_eval(boxes, qboxes, criterion)
    assert got.shape == (40, 25)
    np.testing.assert_allclose(got, want, atol=1e-4)
    if criterion == 2:
        np.testing.assert_allclose(got, rotated_box_intersection(boxes, qboxes), atol=1e-4)


def test_rotated_iou_empty_and_refusals():
    assert rotate_iou_eval(np.zeros((0, 5)), np.zeros((3, 5))).shape == (0, 3)
    with pytest.raises(ValueError):
        native.rotated_iou(np.zeros((3, 4)), np.zeros((3, 5)))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("compute_fp", [False, True])
def test_match_image_matches_the_plain_version(seed, compute_fp):
    overlaps, gt_datas, dt_datas, ig, idt, dc = random_case(np.random.RandomState(seed), 14, 18)
    threshs = [0.0, 0.25, 0.5, 0.75] if compute_fp else [0.0]
    a = native.match_image(overlaps, dt_datas[:, -1], dt_datas[:, 4], gt_datas[:, 4],
                           dt_datas[:, :4], ig, idt, dc, 0, 0.5, np.asarray(threshs, np.float64),
                           compute_fp, True)
    b = ev._match_image_np(overlaps, gt_datas, dt_datas, ig, idt, dc, metric=0,
                           min_overlap=0.5, threshs=threshs, compute_fp=compute_fp,
                           compute_aos=True)
    np.testing.assert_array_equal(a[0], b[0])  # tp
    np.testing.assert_array_equal(a[2], b[2])  # fn
    if compute_fp:
        np.testing.assert_array_equal(a[1], b[1])  # fp
        np.testing.assert_allclose(a[3], b[3], rtol=1e-9)  # sim
    for t in range(len(threshs)):
        np.testing.assert_allclose(sorted(a[4][t]), sorted(b[4][t]))


def test_official_eval_native_equals_plain(monkeypatch):
    rng = np.random.RandomState(0)
    gt, dt = make_annos(rng, n_imgs=25)
    for d in dt:
        d["location"] = d["location"] + rng.randn(*d["location"].shape) * 0.4
    _, ret_native, mod_native = ev.get_official_eval_result(gt, dt, 0)

    monkeypatch.setattr(ev, "rotate_iou_eval", rotate_iou_eval_plain)
    monkeypatch.setattr(ev, "_match_image", ev._match_image_np)
    _, ret_plain, mod_plain = ev.get_official_eval_result(gt, dt, 0)

    np.testing.assert_allclose(mod_native, mod_plain, rtol=1e-9)
    assert ret_native.keys() == ret_plain.keys()
    for k in ret_plain:
        np.testing.assert_allclose(ret_native[k], ret_plain[k], rtol=1e-9, err_msg=k)


def test_bit_equal_to_the_jax_packages_library():
    """One source, one set of flags: the JAX package's committed library
    (native/libkitti_native.so) and the port's build give the same bits."""
    from monodetr_tpu import native as jax_native

    if not jax_native.available():
        pytest.skip("the JAX package's native/libkitti_native.so does not load on this host "
                    "(it was built with -march=native on another CPU)")
    src = kitti_image(3)
    for inv in (crop_transform(), crop_transform(0.9, (600.0, 200.0), (256, 128)),
                np.array([[1.1, 0.05, 3.0], [-0.03, 0.95, 7.0]])):
        a = native.warp_affine_normalize(src, inv, 320, 96, MEAN, STD)
        b = jax_native.warp_affine_normalize(src, inv, 320, 96, MEAN, STD)
        np.testing.assert_array_equal(a, b)
    boxes, qboxes = random_boxes(4)
    for criterion in (-1, 0, 1, 2):
        np.testing.assert_array_equal(native.rotated_iou(boxes, qboxes, criterion),
                                      jax_native.rotated_iou(boxes, qboxes, criterion))
    overlaps, gt_datas, dt_datas, ig, idt, dc = random_case(np.random.RandomState(5), 14, 18)
    args = (overlaps, dt_datas[:, -1], dt_datas[:, 4], gt_datas[:, 4], dt_datas[:, :4], ig, idt,
            dc, 0, 0.5, np.array([0.0, 0.25, 0.5, 0.75]), True, True)
    for x, y in zip(native.match_image(*args), jax_native.match_image(*args)):
        if isinstance(x, list):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)


def test_the_library_comes_from_the_ports_source():
    lib = _build.build_host()
    assert lib.parent.parent == _build.BUILD_ROOT and lib.parent.name.startswith("host-")
    assert _build.HOST_SRC == _build.SRC_DIR / "kitti_native.cpp"
    assert _build.HOST_SRC not in _build.sources()  # not in the nvcc build
    assert "-march=native" in _build.HOST_FLAGS
    log = (lib.parent / "build.log").read_text()
    assert str(_build.HOST_SRC) in log


def test_a_changed_source_or_flag_gives_a_new_build_directory(tmp_path):
    cxx = shutil.which("g++")
    src = tmp_path / "kitti_native.cpp"
    shutil.copy(_build.HOST_SRC, src)
    base = _build.host_digest(src, _build.HOST_FLAGS, cxx)
    assert base == _build.host_digest(_build.HOST_SRC, _build.HOST_FLAGS, cxx)
    assert base != _build.host_digest(src, _build.HOST_FLAGS[:-1] + ("-std=c++20",), cxx)
    src.write_text(src.read_text() + "\n// edited\n")
    edited = _build.host_digest(src, _build.HOST_FLAGS, cxx)
    assert edited != base
    lib = _build.build_host(src=src, root=tmp_path / "build")
    assert lib.parent.name == f"host-{edited}" and lib.exists()


def test_concurrent_builds_all_load_one_library(tmp_path):
    """Four processes build one fresh key at once (as the test workers do):
    each gets the library at the same path and it loads."""
    code = ("import ctypes, sys; sys.path.insert(0, %r); from monodetr_torch import _build; "
            "p = _build.build_host(root=%r); ctypes.CDLL(str(p)); print(p)"
            % (REPO, str(tmp_path)))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    assert len({o.strip() for o in outs}) == 1
    key = _build.host_digest(_build.HOST_SRC, _build.HOST_FLAGS, shutil.which("g++"))
    assert [p.name for p in tmp_path.iterdir()] == [f"host-{key}"]
    assert sorted(p.name for p in next(tmp_path.iterdir()).iterdir()) == [
        "build.log", _build.HOST_LIB_NAME]


def test_a_broken_source_raises_and_the_callers_do_not_fall_back(tmp_path, monkeypatch):
    broken = tmp_path / "kitti_native.cpp"
    broken.write_text(_build.HOST_SRC.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="this is not C"):
        _build.build_host(src=broken, root=tmp_path / "build")
    monkeypatch.setattr(_build, "HOST_SRC", broken)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    _build.host_library.cache_clear()
    try:
        boxes, qboxes = random_boxes(6)
        with pytest.raises(RuntimeError, match="failed"):
            rotate_iou_eval(boxes, qboxes)
        with pytest.raises(RuntimeError, match="failed"):
            native.warp_affine_normalize(kitti_image(7), crop_transform(), 320, 96, MEAN, STD)
    finally:
        _build.host_library.cache_clear()


def test_a_bogus_compiler_raises(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    gxx = bindir / "g++"
    gxx.write_text("#!/bin/sh\necho \"bogus compiler: $*\" >&2\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    with pytest.raises(RuntimeError, match="bogus compiler"):
        _build.build_host(root=tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_host(root=tmp_path / "build")
