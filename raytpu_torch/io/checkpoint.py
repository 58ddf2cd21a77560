"""Fit checkpoints (``raytpu/io/checkpoint.py``, which uses orbax).

Inverse-rendering runs (BASELINE config 4) save their parameters and
optimizer state every N steps and resume from the latest save
(diff/fit.py).  Each save is one ``torch.save`` file named by its step;
the newest ``keep`` are kept.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import torch

_NAME = re.compile(r"step_(\d+)\.pt")


class FitCheckpointer:
    """Step-numbered checkpoints under one directory."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self._dir = os.path.abspath(directory)
        self._keep = keep
        os.makedirs(self._dir, exist_ok=True)

    def steps(self) -> list:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(_NAME.fullmatch,
                                                   os.listdir(self._dir))
                      if m)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step:08d}.pt")

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` (tensors, dicts, lists, tuples and numbers) for
        ``step``, atomically, and drop all but the newest ``keep``."""
        path = self._path(step)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self._keep]:
            os.unlink(self._path(old))

    def restore_latest(self) -> Optional[Tuple[int, Any]]:
        """``(step, state)`` of the newest save, on the CPU, or None."""
        steps = self.steps()
        if not steps:
            return None
        state = torch.load(self._path(steps[-1]), map_location="cpu",
                           weights_only=True)
        return steps[-1], state
