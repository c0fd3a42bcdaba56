"""Bounded profiler window over optimizer steps, and per-window counters.

Counterpart of ``specforge_tpu/training/profiling.py``: a ``torch.profiler``
trace opened before the first step of the configured window and closed on
every exit path (written as a Chrome trace under
``{output_dir}/{run_id}/``), plus the always-on counters the trainer logs
each window: wall-clock by phase (data wait, compute, durable acks), the
kernel launches of the window and the peak device memory.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict


@dataclass
class ProfilingConfig:
    enabled: bool = False
    start_step: int = 10
    num_steps: int = 5
    output_dir: str = "profiles"


class StepProfiler:
    def __init__(self, config: ProfilingConfig, run_id: str = "run"):
        self.config = config
        self.run_id = run_id
        self._prof = None
        self._done = False
        self._window_end = 0

    def on_step_begin(self, step: int) -> None:
        if not self.config.enabled or self._done or self._prof is not None:
            return
        if step >= self.config.start_step:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            self._window_end = step + self.config.num_steps

    def on_step_end(self, step: int) -> None:
        if self._prof is not None and step + 1 >= self._window_end:
            self._stop()

    def finalize(self) -> None:
        if self._prof is not None:
            self._stop()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        path = os.path.join(self.config.output_dir, self.run_id)
        os.makedirs(path, exist_ok=True)
        prof.export_chrome_trace(os.path.join(path, "trace.json"))
        self._done = True


def kernel_launches() -> Dict[str, int]:
    """Launches so far of each hand-written kernel, by its wrapper's name
    (the count each wrapper keeps where it launches; plain CPU calls do
    not count)."""
    from specforge_tpu_torch.ops import (
        attention_cuda,
        dflash_attention_cuda,
        loss_cuda,
        lse_attention_cuda,
        peagle_attention_cuda,
    )

    out = {}
    for module in (attention_cuda, loss_cuda, dflash_attention_cuda,
                   lse_attention_cuda, peagle_attention_cuda):
        for name, fn in vars(module).items():
            if callable(fn) and isinstance(getattr(fn, "launches", None),
                                           int):
                out[name] = fn.launches
    return out


class PerfCounters:
    """Accumulates wall-clock per phase between log windows, the kernel
    launches of the window (where any ran) and, on a card, the process's
    peak device memory so far."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.data_wait_s = 0.0
        self.compute_s = 0.0
        self.ack_s = 0.0
        self.steps = 0
        self.samples = 0
        self._launches = kernel_launches()
        self._window_start = time.monotonic()

    def window_metrics(self) -> Dict[str, float]:
        elapsed = max(time.monotonic() - self._window_start, 1e-9)
        steps = max(self.steps, 1)
        out = {
            "perf/data_wait_s_per_step": self.data_wait_s / steps,
            "perf/compute_s_per_step": self.compute_s / steps,
            "perf/ack_s_per_step": self.ack_s / steps,
            "perf/steps_per_hour": self.steps / elapsed * 3600.0,
            "perf/global_samples_per_s": self.samples / elapsed,
        }
        for name, n in kernel_launches().items():
            if n > self._launches.get(name, 0):
                out[f"perf/launches/{name}"] = n - self._launches.get(name, 0)
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            out["perf/max_memory_allocated"] = torch.cuda.max_memory_allocated()
        return out
