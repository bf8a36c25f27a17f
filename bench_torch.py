"""Benchmark: monodetr_torch training throughput on one CUDA card, the twin
of bench.py; prints bench.py's JSON line (monodetr_torch/bench.py).

    python bench_torch.py [--device cuda]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from monodetr_torch.bench import main  # noqa: E402

if __name__ == "__main__":
    main()
