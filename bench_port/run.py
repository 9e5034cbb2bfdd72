"""Run one cell of BENCHMARK.json once on the card and print its result.

  python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> \
    --trace <0|1>

from the root of a checkout. See harness.py.
"""
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# import from the checkout's root, not from this directory
sys.path[0] = ROOT
# build and kernel caches at fixed paths inside the checkout (the
# program's own nvcc and g++ builds land in <checkout>/build as well)
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))

if __name__ == "__main__":
  from bench_port import harness
  sys.exit(harness.main(sys.argv[1:], t_start=T_START))
