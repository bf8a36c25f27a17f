"""monodetr_torch — MonoDETR monocular 3-D detection in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors `monodetr_tpu` module for module (`ops/`, `models/`,
`eval/`) and is held against it by the `tests/test_torch_*.py` parity tests.
It imports torch and never jax.  The CUDA kernels under `csrc/` are built at
first use by `_build.py`; every kernel wrapper takes its plain PyTorch
version for a tensor on the CPU and launches the kernel (or raises) for a
tensor on a CUDA device.
"""

__version__ = "0.1.0"
