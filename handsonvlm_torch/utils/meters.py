"""Timing / loss meters (reference: hoi_forecast/model/epoch_utils.py:14-40).

A copy of `handsonvlm_tpu/utils/meters.py`, which imports no JAX.
"""

from __future__ import annotations

from typing import Dict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0


class AverageMeters:
    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}

    def add_loss_value(self, name: str, val: float, n: int = 1):
        self.meters.setdefault(name, AverageMeter()).update(val, n)

    def average(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def __getitem__(self, name: str) -> AverageMeter:
        return self.meters[name]
