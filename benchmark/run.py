"""Run one cell of the benchmark on this machine's card and print its result line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the last lines of standard error hold each compared number
beside its limit. Exits non-zero, with no result, where the cell's cards
are missing or the run imported JAX or the JAX package.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
