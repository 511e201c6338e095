"""The benchmark's own CPU tests: `python -m pytest perfbench/tests`.

They drive the harness on the CPU, where the system runs its plain
twins, at tiny sizes; nothing here needs a card."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

# several test workers share the host: one intra-op thread each
torch.set_num_threads(1)
