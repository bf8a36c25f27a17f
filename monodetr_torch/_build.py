"""Build and load the hand-written CUDA kernels.

`library()` compiles every `csrc/*.cu` into one shared library with a plain C
interface (nvcc, `sm_90a`; one compiler process per source, run together,
then one link), at first use, into `build/monodetr_torch/<hash>/`
beside the package; the hash covers the sources and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded from disk.  The library is
bound with ctypes: every pointer and the CUDA stream pass as `c_void_p`, and
every entry point returns `cudaGetLastError()` after its launch, which
`check()` turns into an exception.  There is no fallback: without nvcc the
build raises.

`host_library()` does the same for the loader's and the evaluator's host
kernels (`csrc/kitti_native.cpp`, which the CUDA build does not take): g++
with `-march=native` into `build/monodetr_torch/host-<hash>/`, the hash over
the source, the flags, the compiler's version and this CPU's flag set, so
a build directory copied to another host is rebuilt there.  A failed
build raises with the compiler's output.
"""

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "monodetr_torch"
LIB_NAME = "libmonodetr_kernels.so"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_SRC = SRC_DIR / "kitti_native.cpp"
HOST_LIB_NAME = "libkitti_native.so"
HOST_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC", "-std=c++17")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_L = ctypes.c_longlong
# entry point -> argument types (see csrc/*.cu)
SIGNATURES = {
    "mdt_msda_enc_fused": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _F, _P),
    "mdt_msda_enc_fused_bwd_tiles": (_P,) * 9 + (_I,) * 7 + (_P, _P, _P, _F, _P),
    "mdt_msda_sep": (_P,) * 4 + (_I,) * 8 + (_P, _P),
    "mdt_msda_sep_bwd": (_P,) * 7 + (_I,) * 8 + (_P, _P),
    "mdt_msda_pallas": (_P,) * 5 + (_I,) * 7 + (_P, _P),
    "mdt_msda_pallas_bwd": (_P,) * 9 + (_I,) * 7 + (_P, _P, _P, _F, _P),
    "mdt_msda_sepwin": (_P,) * 4 + (_I,) * 7 + (_P, _F, _P),
    "mdt_msda_sepwin_bwd": (_P,) * 7 + (_I,) * 7 + (_P, _P, _P, _F, _P),
    "mdt_msda_win_bwd_occupancy": (_I, _I, _I, _P, _P, _P),
    "mdt_msda_dense_fused": (_P,) * 4 + (_I,) * 8 + (_P, _P),
    "mdt_msda_dense_fused_bwd": (_P,) * 9 + (_I,) * 8 + (_P, _P, _P),
    "mdt_attention_fwd": (_P,) * 5 + (_I,) * 5 + (_F, _P, _U, _P),
    "mdt_attention_bwd": (_P,) * 10 + (_I,) * 5 + (_F, _P, _U, _P),
    "mdt_attention_keep_mask": (_P, _I, _I, _I, _P, _U, _P),
    "mdt_lap": (_P, _P, _P, _I, _I, _P),
    "mdt_lap_probe": (_P, _I, _P),
    "mdt_backbone_bias_relu": (_P,) * 3 + (_I, _L, _I, _P),
    "mdt_backbone_tail": (_P,) * 5 + (_I, _L, _I, _P),
    "mdt_backbone_accumulate_mask": (_P,) * 4 + (_I, _L, _I, _P),
}
_D = ctypes.c_double
# host entry point -> argument types (see csrc/kitti_native.cpp); pointers
# are typed, so numpy's `ctypes.data_as` pointers pass as they are
HOST_SIGNATURES = {
    "warp_affine_normalize": (ctypes.POINTER(ctypes.c_uint8), _I, _I, ctypes.POINTER(_D),
                              ctypes.POINTER(_F), _I, _I, ctypes.POINTER(_F),
                              ctypes.POINTER(_F)),
    "rotated_iou": (ctypes.POINTER(_D), _I, ctypes.POINTER(_D), _I, _I, ctypes.POINTER(_F)),
    "match_image": (ctypes.POINTER(_D), _I, _I) + (ctypes.POINTER(_D),) * 4
                   + (ctypes.POINTER(_L),) * 2 + (ctypes.POINTER(_D), _I, _I, _D,
                                                  ctypes.POINTER(_D), _I, _I, _I)
                   + (ctypes.POINTER(_L),) * 3 + (ctypes.POINTER(_D),) * 2
                   + (ctypes.POINTER(_L),),
}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "monodetr_torch: nvcc not found (PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin); the CUDA kernels are built from "
        "monodetr_torch/csrc at first use and need the CUDA toolkit")


def sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path.  Each build works in a temporary directory and
    renames the library into place, so concurrent builds never load a
    half-written library."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        # one nvcc per source, all at once, then one link
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(work / (src.stem + ".o"))]
                for src in sorted(SRC_DIR.glob("*.cu"))]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in logs):
            link = [nvcc, "-shared", "-o", str(work / LIB_NAME), *[c[-1] for c in cmds]]
            proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            logs.append((link, proc.stdout, proc.returncode))
        (out_dir / "build.log").write_text(
            "".join(" ".join(c) + "\n" + out for c, out, _ in logs))
        failed = [(c, out, rc) for c, out, rc in logs if rc != 0]
        if failed:
            c, out, rc = failed[0]
            raise RuntimeError(f"monodetr_torch: {' '.join(c)} failed ({rc}):\n{out[-4000:]}")
        os.replace(work / LIB_NAME, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.mdt_error_string.argtypes = [ctypes.c_int]
    lib.mdt_error_string.restype = ctypes.c_char_p
    return lib


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("monodetr_torch: g++ not found on PATH; the host kernels are "
                           "built from monodetr_torch/csrc/kitti_native.cpp at first use")
    return cxx


def cpu_flags() -> str:
    """This CPU's feature flags (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine() + " " + platform.processor()


def host_digest(src: Path, flags, cxx: str) -> str:
    """The host library's build key: source, flags, compiler version, CPU."""
    version = subprocess.run([cxx, "--version"], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True).stdout
    h = hashlib.sha256(" ".join(flags).encode())
    for part in (src.read_bytes(), version.encode(), cpu_flags().encode()):
        h.update(b"\0" + part)
    return h.hexdigest()[:16]


def build_host(src: Path = None, root: Path = None) -> Path:
    """Compile the host kernels (HOST_SRC, or `src`) under BUILD_ROOT (or
    `root`) if this build key has no library yet; return the library's
    path.  Built in a temporary directory and renamed into place, as
    `build()` does."""
    src = HOST_SRC if src is None else Path(src)
    root = BUILD_ROOT if root is None else Path(root)
    cxx = _cxx()
    out_dir = root / f"host-{host_digest(src, HOST_FLAGS, cxx)}"
    lib = out_dir / HOST_LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        cmd = [cxx, *HOST_FLAGS, "-o", str(work / HOST_LIB_NAME), str(src)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        (work / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout)
        os.replace(work / "build.log", out_dir / "build.log")
        if proc.returncode != 0:
            raise RuntimeError(f"monodetr_torch: {' '.join(cmd)} failed ({proc.returncode}):\n"
                               f"{proc.stdout[-4000:]}")
        os.replace(work / HOST_LIB_NAME, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    """The loaded host kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build_host()))
    for name, argtypes in HOST_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = None
    return lib


def check(rc: int, name: str):
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = library().mdt_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def launch(name: str, *args):
    """Call entry point `name` of the kernel library and raise on the CUDA
    error it reports."""
    check(getattr(library(), name)(*args), name)


def require_cuda(name: str, *tensors):
    """Raise unless every tensor is a contiguous tensor on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def dtype_code(dtype) -> int:
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")
    return codes[dtype]


@functools.lru_cache(maxsize=64)
def _levels_arg(flat):
    return (ctypes.c_int * len(flat))(*flat)


def levels_arg(spatial_shapes):
    """Host int array (h0, w0, h1, w1, ...) for a kernel's `hw` argument
    (one array per pyramid, made once: the kernels only read it)."""
    return _levels_arg(tuple(int(x) for hw in spatial_shapes for x in hw))


def ints_arg(values):
    """Host int array for a kernel's table argument."""
    return (ctypes.c_int * len(values))(*(int(v) for v in values))


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
