"""Run one cell of the port's benchmark once; see benchmark/harness/main.py.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Every build and kernel cache at a fixed path inside the checkout.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path.insert(0, str(ROOT))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main.main(sys.argv[1:], T_START))
