"""The benchmark of pindel_tpu_torch, one cell a run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for (``BENCHMARK.json``).  It exits 3 without a result where no card is
visible.  Build caches stay inside the checkout: the port's under
``pindel_tpu_torch/build/`` and any other kernel cache under
``.bench_cache/``.  See ``harness.py`` for what a run does.
"""
import os
import sys
import time

T0 = time.monotonic()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

if __name__ == "__main__":
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    sys.path.append(ROOT)
    import harness
    sys.exit(harness.main(sys.argv[1:], T0))
