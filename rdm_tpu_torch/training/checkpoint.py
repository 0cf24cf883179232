"""Checkpoints of the train state, over torch.save / torch.load.

Counterpart of `rdm_tpu/training/checkpoint.py` (Orbax there; the layout
is not Orbax's): one directory per step, `<directory>/<step>/state.pt`,
written under a temporary name and renamed into place, the newest
`max_to_keep` kept, and `best_steps.json` holding the monitored metric of
each step saved with it. `install_signal_checkpoint` saves on SIGUSR1.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import tempfile
from typing import Any, Callable, List, Optional

import torch

_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3,
                 monitor: Optional[str] = None, mode: str = "min"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.mode = mode
        self._metrics_file = os.path.join(self.directory, "best_steps.json")

    def steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self.directory, d, _FILE)))

    def save(self, step: int, state: Any,
             metrics: Optional[dict] = None) -> None:
        """state: a picklable tree of tensors (e.g. TrainState.state_dict())."""
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".saving-")
        torch.save(state, os.path.join(tmp, _FILE))
        final = os.path.join(self.directory, str(step))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        if metrics and self.monitor and self.monitor in metrics:
            data = {}
            if os.path.isfile(self._metrics_file):
                with open(self._metrics_file) as f:
                    data = json.load(f)
            data[str(step)] = float(metrics[self.monitor])
            with open(self._metrics_file, "w") as f:
                json.dump(data, f)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(os.path.join(self.directory, str(step), _FILE),
                          map_location=map_location, weights_only=True)

    def best_step(self) -> Optional[int]:
        if not os.path.isfile(self._metrics_file):
            return self.latest_step()
        with open(self._metrics_file) as f:
            data = json.load(f)
        if not data:
            return self.latest_step()
        key = min if self.mode == "min" else max
        return int(key(data, key=lambda k: data[k]))


def install_signal_checkpoint(save_fn: Callable[[], None]) -> None:
    """SIGUSR1 -> checkpoint now (preemptible-cluster semantics)."""

    def _handler(signum, frame):
        print("SIGUSR1 received - saving checkpoint")
        save_fn()

    signal.signal(signal.SIGUSR1, _handler)
