"""Training traffic at the north star's size: traffic/train.py's closed
loop of fused train steps, unchanged (one client, fits of `fit_steps`
steps, the check of the first `check.steps` steps against the plain
reference).

A traffic kind of its own only because a pair of configuration and
traffic names one cell: `cornell.train` already pairs the `cornell`
configuration with `train`. The sizes (600x600, spp 200, 20 bounces,
every field trainable) are the cell's workload file's, as for every
cell. Parameters as traffic/train.py's.
"""

from __future__ import annotations

from perfbench.traffic.train import Cell

__all__ = ["Cell"]
