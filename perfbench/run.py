"""Entry point of the benchmark: run one cell on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up time is counted from here. See ``harness.py``.
"""

import os
import sys
import time

T0 = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# no library loads JAX on its own; caches stay in the checkout
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, ".perfbench_cache", "triton"))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
