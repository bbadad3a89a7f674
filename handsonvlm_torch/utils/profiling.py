"""Profiling: torch.profiler trace capture and per-step timing.

Port of `handsonvlm_tpu/utils/profiling.py`. `trace(log_dir)` records the
enclosed region with `torch.profiler` (the host's operators, and the
card's kernels when CUDA is available) and writes it as a Chrome trace,
`<log_dir>/trace_<pid>_<ms>.json`, viewable in Perfetto or
chrome://tracing; it yields the profiler, whose `key_averages()` give the
table. `StepTimer` gives steady-state steps/sec, its first `warmup` steps
left out. The JAX package's `start_server` (an on-demand capture server
for TensorBoard) has no torch counterpart: here it raises.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed region into
    `log_dir` as a Chrome trace (JSON)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


def start_server(port: int = 9999):
    """The JAX package starts jax.profiler's capture server here; torch has
    no such server."""
    raise NotImplementedError(
        "torch.profiler has no on-demand capture server (jax.profiler.start_server's "
        f"counterpart, port {port}): wrap the region in profiling.trace(log_dir) instead")


class StepTimer:
    """Steady-state step timing: skips the first `warmup` steps (compile,
    kernel builds, allocator warm-up), reports steps/sec and a rolling mean.
    Time on the host's clock: synchronize the device inside the step to
    time its work."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.total = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += dt

    @property
    def steady_steps(self) -> int:
        return max(self.count - self.warmup, 0)

    @property
    def sec_per_step(self) -> float:
        return self.total / self.steady_steps if self.steady_steps else float("nan")

    @property
    def steps_per_sec(self) -> float:
        s = self.sec_per_step
        return 1.0 / s if s == s and s > 0 else float("nan")

    def summary(self) -> Dict[str, float]:
        return {
            "steps": float(self.count),
            "sec_per_step": self.sec_per_step,
            "steps_per_sec": self.steps_per_sec,
        }
