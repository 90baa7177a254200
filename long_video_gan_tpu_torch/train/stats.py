"""Training statistics.

Counterpart of `long_video_gan_tpu/train/stats.py`: update steps return dicts
of (count, sum, sum of squares) moment triples, and a host-side Collector
accumulates them between ticks and reports mean/std over the window since the
last `update()`. With several processes, `update()` sums each window's
triples over them, so the means are those of the global batch.
"""

from __future__ import annotations

import json
import re
import time
from typing import Optional

import numpy as np
import torch

from ..parallel import mesh


def moments(x: torch.Tensor) -> torch.Tensor:
    """[count, sum, sum of squares] of all elements, as float32."""
    x = x.detach().float()
    return torch.stack([torch.tensor(float(x.numel()), device=x.device), x.sum(),
                        x.square().sum()])


def scalar_moments(value) -> torch.Tensor:
    v = torch.as_tensor(value, dtype=torch.float32).detach()
    return torch.stack([torch.ones_like(v), v, v.square()])


def loss_moments(loss: torch.Tensor) -> torch.Tensor:
    """A micro-batch loss's moments, of its mean over the processes, so that
    the statistics match one process's at the same global batch."""
    return scalar_moments(mesh.mean_over_processes(loss))


def accumulate(totals: Optional[dict], terms: dict) -> dict:
    """A phase's running sums over its micro-batches: `totals` (None: zero
    triples) plus one micro-batch's moment triples `terms`, key by key."""
    if totals is None:
        zero = torch.zeros(3, device=next(iter(terms.values())).device)
        totals = dict.fromkeys(terms, zero)
    return {name: totals[name] + term for name, term in terms.items()}


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
        """Snapshot the window: deltas since the last update, summed over
        the processes (one flat all_reduce over the sorted names; every
        process reports the same names)."""
        self._deltas = {name: total - self._prev.get(name, np.zeros(3))
                        for name, total in self._totals.items()}
        self._prev = {name: total.copy() for name, total in self._totals.items()}
        if mesh.distributed() and self._deltas:
            names = sorted(self._deltas)
            flat = torch.from_numpy(np.stack([self._deltas[k] for k in names]))
            summed = mesh.all_reduce_sum_([flat.to(mesh.comm_device())])[0].cpu().numpy()
            self._deltas.update(zip(names, summed))

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


def write_tick(collector: Collector, stats_fp, step: int, tick: int, steps_per_tick: int,
               tick_start: float, start_time: float, device: torch.device) -> dict:
    """Append the tick's record (the statistics' means since the last tick,
    sec/step, peak device memory) to the open stats.jsonl `stats_fp` and
    print its summary; the trainer CLIs' per-tick report. Every process
    calls it (the window's sum is a collective); one with `stats_fp` None
    writes and prints nothing."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sec_per_step = (time.time() - tick_start) / steps_per_tick
    collector.update()
    record = {name: v["mean"] for name, v in collector.as_dict().items()}
    record.update(step=step, tick=tick, sec_per_step=sec_per_step,
                  total_sec=time.time() - start_time, timestamp=time.time(),
                  peak_device_mem_gb=(torch.cuda.max_memory_allocated(device) / 2**30
                                      if device.type == "cuda" else None))
    if stats_fp is None:
        return record
    stats_fp.write(json.dumps(record) + "\n")
    stats_fp.flush()
    print(f"step {step:<8d} tick {tick:<5d} sec/step {sec_per_step:<7.3f} "
          f"G_loss {record.get('loss/G_loss', float('nan')):.3f} "
          f"D_loss {record.get('loss/D_loss', float('nan')):.3f}"
          + (f" ada_p {record['progress/augment_p']:.4f}" if "progress/augment_p" in record
             else ""))
    return record
