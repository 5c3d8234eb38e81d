"""The benchmark's CPU tests import ``portbench`` and the program from the
repository's root, as ``portbench/run.py`` does."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# One intra-op thread: the tests run beside other workers.
torch.set_num_threads(1)
