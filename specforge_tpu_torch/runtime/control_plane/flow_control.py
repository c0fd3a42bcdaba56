"""Producer flow control: hysteretic pause and resume on in-flight refs
and bytes.

Counterpart of ``specforge_tpu/runtime/control_plane/flow_control.py``:
production pauses above the high watermark and resumes below the low one.
The store's ``MemoryError`` stays the loud last resort.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional


@dataclass
class FlowControlConfig:
    high_watermark_refs: int = 256
    low_watermark_refs: int = 128
    high_watermark_bytes: Optional[int] = None
    low_watermark_bytes: Optional[int] = None
    max_leases_per_worker: int = 8

    def __post_init__(self):
        if self.low_watermark_refs > self.high_watermark_refs:
            raise ValueError("low watermark must be <= high watermark")
        if (self.high_watermark_bytes is not None
                and self.low_watermark_bytes is not None
                and self.low_watermark_bytes > self.high_watermark_bytes):
            raise ValueError("low byte watermark must be <= high")


class ProducerFlowControl:
    def __init__(self, config: FlowControlConfig) -> None:
        self.config = config
        self._lock = threading.Lock()
        self._in_flight_refs = 0
        self._in_flight_bytes = 0
        self._paused = False
        self._pause_events = 0

    def on_published(self, n_refs: int, n_bytes: int = 0) -> None:
        with self._lock:
            self._in_flight_refs += n_refs
            self._in_flight_bytes += n_bytes
            self._update()

    def on_consumed(self, n_refs: int, n_bytes: int = 0) -> None:
        with self._lock:
            self._in_flight_refs = max(0, self._in_flight_refs - n_refs)
            self._in_flight_bytes = max(0, self._in_flight_bytes - n_bytes)
            self._update()

    def set_in_flight(self, n_refs: int, n_bytes: int = 0) -> None:
        """Absolute update from a channel's consumed counter."""
        with self._lock:
            self._in_flight_refs = n_refs
            self._in_flight_bytes = n_bytes
            self._update()

    def _update(self) -> None:
        cfg = self.config
        over = self._in_flight_refs >= cfg.high_watermark_refs or (
            cfg.high_watermark_bytes is not None
            and self._in_flight_bytes >= cfg.high_watermark_bytes
        )
        under = self._in_flight_refs <= cfg.low_watermark_refs and (
            cfg.low_watermark_bytes is None
            or self._in_flight_bytes <= cfg.low_watermark_bytes
        )
        if not self._paused and over:
            self._paused = True
            self._pause_events += 1
        elif self._paused and under:
            self._paused = False

    @property
    def paused(self) -> bool:
        with self._lock:
            return self._paused

    def health(self) -> dict:
        with self._lock:
            return {
                "in_flight_refs": self._in_flight_refs,
                "in_flight_bytes": self._in_flight_bytes,
                "paused": self._paused,
                "pause_events": self._pause_events,
            }
