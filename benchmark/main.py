"""Benchmark of the PyTorch/CUDA Point-GNN port (``pointgnn_tpu_torch``).

    python3 benchmark/main.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the GPU it is started on and
prints one JSON result as its last line.  Without a CUDA device it exits
with code 2 and prints no result.  See ``core/harness.py``.
"""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.core import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
