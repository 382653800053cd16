"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card. The last line of
standard output is the result (JSON); the last lines of standard error give
each number that decided ``correct`` beside its limit.
"""

import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# build and kernel caches at fixed paths inside the checkout, so that only
# the first run of a cell in a checkout compiles
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(HERE / ".cache" / sub)
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(HERE.parent))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
