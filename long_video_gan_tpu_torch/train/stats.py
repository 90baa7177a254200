"""Training statistics.

Counterpart of `long_video_gan_tpu/train/stats.py`: update steps return dicts
of (count, sum, sum of squares) moment triples, and a host-side Collector
accumulates them between ticks and reports mean/std over the window since the
last `update()`.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def moments(x: torch.Tensor) -> torch.Tensor:
    """[count, sum, sum of squares] of all elements, as float32."""
    x = x.detach().float()
    return torch.stack([torch.tensor(float(x.numel()), device=x.device), x.sum(),
                        x.square().sum()])


def scalar_moments(value) -> torch.Tensor:
    v = torch.as_tensor(value, dtype=torch.float32).detach()
    return torch.stack([torch.ones_like(v), v, v.square()])


class Collector:
    """Accumulates moment dicts host-side; mean/std over the window since the
    previous update() call."""

    def __init__(self, regex: str = ".*"):
        self._regex = re.compile(regex)
        self._totals: dict[str, np.ndarray] = {}
        self._prev: dict[str, np.ndarray] = {}
        self._deltas: dict[str, np.ndarray] = {}

    def report(self, stats: dict) -> None:
        for name, m in stats.items():
            if not self._regex.fullmatch(name):
                continue
            if isinstance(m, torch.Tensor):
                m = m.detach().cpu().numpy()
            m = np.asarray(m, np.float64)
            self._totals[name] = self._totals.get(name, np.zeros(3)) + m

    def update(self) -> None:
        """Snapshot the window: deltas since the last update."""
        self._deltas = {name: total - self._prev.get(name, np.zeros(3))
                        for name, total in self._totals.items()}
        self._prev = {name: total.copy() for name, total in self._totals.items()}

    def names(self):
        return list(self._deltas.keys())

    def mean(self, name: str) -> float:
        d = self._deltas.get(name)
        if d is None or d[0] == 0:
            return float("nan")
        return float(d[1] / d[0])

    def std(self, name: str) -> float:
        d = self._deltas.get(name)
        if d is None or d[0] == 0 or not np.isfinite(d[1] / d[0]):
            return 0.0
        if d[0] == 1:
            return 0.0
        mean = d[1] / d[0]
        raw_var = d[2] / d[0]
        return float(np.sqrt(max(raw_var - mean ** 2, 0)))

    def __getitem__(self, name: str) -> float:
        return self.mean(name)

    def as_dict(self) -> dict[str, dict[str, float]]:
        return {name: dict(mean=self.mean(name), std=self.std(name),
                           num=float(self._deltas[name][0]))
                for name in self._deltas}
