"""Minimal host-side progress reporting (the reference uses indicatif,
renderer/renderer.rs:50-54). Prints a single updating line to stderr."""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, total: int, label: str = "", stream=None):
        self.total = max(1, int(total))
        self.done = 0
        self.label = label
        self.stream = stream or sys.stderr
        self.t0 = time.time()

    def update(self, n: int = 1) -> None:
        self.done = min(self.total, self.done + n)
        frac = self.done / self.total
        width = 30
        filled = int(frac * width)
        elapsed = time.time() - self.t0
        self.stream.write(
            f"\r[{'#' * filled}{'.' * (width - filled)}] "
            f"{self.done}/{self.total} {self.label} ({elapsed:.1f}s)"
        )
        self.stream.flush()

    def close(self) -> None:
        self.stream.write("\n")
        self.stream.flush()
