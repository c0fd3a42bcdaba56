"""Streaming ref channel: an fsync'd append-only JSONL and sidecar counters.

Counterpart of ``specforge_tpu/runtime/data_plane/streaming_ref_channel.py``
and byte-compatible with it: the producer publishes SampleRef records (and
lifecycle sentinels) to ``{name}.jsonl`` with atomic ``{name}.published``,
``.consumed`` and ``.quantum`` counter files; the consumer polls by byte
offset (idempotent reads) and reports a consumed count back for producer
flow control.

Record kinds: {"kind": "ref", ...SampleRef json}, {"kind": "closed"},
{"kind": "failed", "error": ...}; the consumer publishes its optimizer
window (``.quantum``) so the producer can align releases.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

from specforge_tpu_torch.runtime.contracts import SampleRef


def _atomic_write(path: str, text: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_int(path: str, default: int = 0) -> int:
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return default


@dataclass
class ChannelStatus:
    published: int
    consumed: int
    closed: bool
    failed: Optional[str]

    @property
    def in_flight(self) -> int:
        return max(0, self.published - self.consumed)


class StreamingRefChannel:
    """One producer, one reader (the RefDistributor)."""

    def __init__(self, control_dir: str, name: str = "refs") -> None:
        self.control_dir = os.path.abspath(control_dir)
        os.makedirs(self.control_dir, exist_ok=True)
        self.path = os.path.join(self.control_dir, f"{name}.jsonl")
        self._published_path = os.path.join(
            self.control_dir, f"{name}.published"
        )
        self._consumed_path = os.path.join(self.control_dir, f"{name}.consumed")
        self._quantum_path = os.path.join(self.control_dir, f"{name}.quantum")
        self._write_lock = threading.Lock()
        self._read_offset = 0
        self._published = _read_int(self._published_path)

    # --- producer side ----------------------------------------------------
    def _append(self, records: List[dict]) -> None:
        with self._write_lock:
            with open(self.path, "a") as f:
                for record in records:
                    f.write(json.dumps(record) + "\n")
                f.flush()
                os.fsync(f.fileno())

    def publish_batch(self, refs: Iterable[SampleRef]) -> int:
        records = [{"kind": "ref", **ref.to_json()} for ref in refs]
        if not records:
            return 0
        self._append(records)
        with self._write_lock:
            self._published += len(records)
            _atomic_write(self._published_path, str(self._published))
        return len(records)

    def close(self) -> None:
        self._append([{"kind": "closed"}])

    def fail(self, error: str) -> None:
        self._append([{"kind": "failed", "error": error}])

    def consumed_count(self) -> int:
        return _read_int(self._consumed_path)

    def consumer_quantum(self) -> int:
        return _read_int(self._quantum_path)

    def in_flight_remote(self) -> int:
        return max(0, self._published - self.consumed_count())

    # --- consumer side ----------------------------------------------------
    def poll(self, limit: int = 0) -> Tuple[List[SampleRef], bool, Optional[str]]:
        """(new refs, closed?, failure) from the current byte offset."""
        refs: List[SampleRef] = []
        closed = False
        failure: Optional[str] = None
        if not os.path.exists(self.path):
            return refs, closed, failure
        with open(self.path, "r") as f:
            f.seek(self._read_offset)
            while True:
                line_start = f.tell()
                line = f.readline()
                if not line or not line.endswith("\n"):
                    # partial tail: re-read next poll
                    self._read_offset = line_start
                    break
                self._read_offset = f.tell()
                record = json.loads(line)
                kind = record.pop("kind", "ref")
                if kind == "ref":
                    refs.append(SampleRef.from_json(record))
                    if limit and len(refs) >= limit:
                        break
                elif kind == "closed":
                    closed = True
                elif kind == "failed":
                    failure = record.get("error", "producer failed")
        return refs, closed, failure

    def mark_consumed(self, n: int) -> None:
        current = _read_int(self._consumed_path)
        _atomic_write(self._consumed_path, str(current + n))

    def publish_consumer_quantum(self, size: int) -> None:
        _atomic_write(self._quantum_path, str(int(size)))

    def status(self) -> ChannelStatus:
        refs_published = _read_int(self._published_path)
        _refs, closed, failed = StreamingRefChannel(
            self.control_dir, os.path.basename(self.path)[:-6]
        ).poll()  # fresh reader: non-destructive status probe
        return ChannelStatus(
            published=refs_published,
            consumed=self.consumed_count(),
            closed=closed,
            failed=failed,
        )


class StreamingRefQueue:
    """In-process consume-once adapter with the same producer surface."""

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self.published = 0
        self.consumed = 0

    def publish_batch(self, refs: Iterable[SampleRef]) -> int:
        n = 0
        for ref in refs:
            self._q.put(ref)
            n += 1
        self.published += n
        return n

    def close(self) -> None:
        self._q.put(None)

    def get(self, timeout: Optional[float] = None) -> Optional[SampleRef]:
        item = self._q.get(timeout=timeout)
        if item is not None:
            self.consumed += 1
        return item

    @property
    def queue(self) -> "queue.Queue":
        return self._q
