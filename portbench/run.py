"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device` (and with --trace 1 a
`breakdown`), then `checks`, each number the correctness check compared
beside its limit. Exits non-zero without a result when the machine lacks
the cards the cell asks for, when the window runs out of frames, or when
JAX or the JAX package is loaded. The cell, its configuration, traffic
and metrics are found by name from BENCHMARK.json (portbench/README.md).
"""

import time

T_START = time.perf_counter()  # set-up is timed from here: before any import

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own kernel build goes to .torch_build/ beside its package)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / ".portbench_cache" / _sub)
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
