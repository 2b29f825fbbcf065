"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from
the repository's root.  They put the benchmark's directory first on the
path, as ``python3 benchmark/run.py`` does, and the repository's root after
it for the port and its test scenes."""
import os
import sys

import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.append(ROOT)
torch.set_num_threads(2)
