"""Metric trackers behind one ``log(metrics, step)`` seam.

Counterpart of ``specforge_tpu/training/tracking.py`` for the backends that
need no extra package: no-op, stdout and JSONL, combinable with commas. The
other backends' packages (tensorboard, wandb, mlflow, swanlab) are not on
the machine with the card; :func:`build_tracker` refuses them, naming the
roadmap item that brings them.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger("specforge_tpu_torch.tracking")

_SECRET_RE = re.compile(r"(key|token|secret|password)", re.IGNORECASE)
QUEUED_BACKENDS = ("tensorboard", "wandb", "mlflow", "swanlab")


def redact_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively mask values under secret-looking keys before logging."""
    def _walk(obj):
        if isinstance(obj, dict):
            return {
                k: ("<redacted>" if _SECRET_RE.search(str(k)) else _walk(v))
                for k, v in obj.items()
            }
        if isinstance(obj, (list, tuple)):
            return [_walk(v) for v in obj]
        return obj

    return _walk(config)


class Tracker:
    def log(self, metrics: Dict[str, float], step: int) -> None: ...

    def log_config(self, config: Dict[str, Any]) -> None: ...

    def finish(self) -> None: ...


class NoOpTracker(Tracker):
    pass


class StdoutTracker(Tracker):
    def log(self, metrics, step):
        short = {k: round(float(v), 6) for k, v in sorted(metrics.items())}
        logger.info("step %d: %s", step, short)


class JsonlTracker(Tracker):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)

    def log(self, metrics, step):
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(record) + "\n")

    def log_config(self, config):
        self._f.write(json.dumps({"config": redact_config(config)}) + "\n")

    def finish(self):
        self._f.close()


class MultiTracker(Tracker):
    def __init__(self, trackers: List[Tracker]):
        self.trackers = trackers

    def log(self, metrics, step):
        for t in self.trackers:
            t.log(metrics, step)

    def log_config(self, config):
        for t in self.trackers:
            t.log_config(config)

    def finish(self):
        for t in self.trackers:
            t.finish()


def build_tracker(
    backend: str = "none",
    *,
    output_dir: str = ".",
    run_id: str = "run",
    project: Optional[str] = None,
) -> Tracker:
    """'none' | 'stdout' | 'jsonl' (comma-combinable)."""
    del project  # used only by the queued backends
    trackers: List[Tracker] = []
    for name in backend.split(","):
        name = name.strip()
        if name in ("", "none"):
            continue
        if name == "stdout":
            trackers.append(StdoutTracker())
        elif name == "jsonl":
            trackers.append(
                JsonlTracker(os.path.join(output_dir, f"{run_id}.metrics.jsonl"))
            )
        elif name in QUEUED_BACKENDS:
            raise NotImplementedError(
                f"tracker backend {name!r} is not ported (its package is not "
                "on the machine with the card); see ROADMAP.md, Queue 1"
            )
        else:
            raise ValueError(f"unknown tracker backend {name!r}")
    if not trackers:
        return NoOpTracker()
    if len(trackers) == 1:
        return trackers[0]
    return MultiTracker(trackers)
