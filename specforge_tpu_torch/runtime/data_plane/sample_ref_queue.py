"""SampleRefQueue: in-process staging queue with lease, ack and fail.

Counterpart of ``specforge_tpu/runtime/data_plane/sample_ref_queue.py``:
staging is idempotent on ``sample_id``; consumers LEASE refs (invisible to
other consumers while leased), ACK to remove them for good, or FAIL to
return them for redelivery (at least once). Attempt counts cap poisoned
refs.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from specforge_tpu_torch.runtime.contracts import SampleRef


@dataclass
class _Entry:
    ref: SampleRef
    attempts: int = 0
    leased_by: Optional[str] = None


@dataclass
class SampleRefQueue:
    max_attempts: int = 3
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _entries: "OrderedDict[str, _Entry]" = field(default_factory=OrderedDict)
    _acked: set = field(default_factory=set)
    _poisoned: set = field(default_factory=set)

    def stage(self, refs) -> int:
        """Idempotent staging; already-staged/acked/poisoned ids are skipped.
        Returns the number of newly staged refs."""
        n = 0
        with self._lock:
            for ref in refs:
                sid = ref.sample_id
                if (
                    sid in self._entries
                    or sid in self._acked
                    or sid in self._poisoned
                ):
                    continue
                self._entries[sid] = _Entry(ref=ref)
                n += 1
        return n

    def lease(self, consumer: str, limit: int = 1) -> List[SampleRef]:
        out: List[SampleRef] = []
        with self._lock:
            for entry in self._entries.values():
                if len(out) >= limit:
                    break
                if entry.leased_by is None:
                    entry.leased_by = consumer
                    entry.attempts += 1
                    out.append(entry.ref)
        return out

    def ack(self, sample_ids) -> None:
        with self._lock:
            for sid in sample_ids:
                if self._entries.pop(sid, None) is not None:
                    self._acked.add(sid)

    def fail(self, sample_ids, error: str = "") -> None:
        """Return leased refs to the ready state; poison past max_attempts."""
        with self._lock:
            for sid in sample_ids:
                entry = self._entries.get(sid)
                if entry is None:
                    continue
                entry.leased_by = None
                if entry.attempts >= self.max_attempts:
                    del self._entries[sid]
                    self._poisoned.add(sid)

    def status(self) -> Dict[str, int]:
        with self._lock:
            leased = sum(
                1 for e in self._entries.values() if e.leased_by is not None
            )
            return {
                "staged": len(self._entries),
                "leased": leased,
                "ready": len(self._entries) - leased,
                "acked": len(self._acked),
                "poisoned": len(self._poisoned),
            }
