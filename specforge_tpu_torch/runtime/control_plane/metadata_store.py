"""Metadata stores: the durable control-plane ledger.

Counterpart of ``specforge_tpu/runtime/control_plane/metadata_store.py``:
InMemory (tests, colocated), NoOp, and SQLite (WAL journal: the one
cross-process ledger of disaggregated consumers). Records: committed sample
refs (dedup), durably acked sample ids, and the durable optimizer-step
marker. The SQLite schema is the JAX package's, so a ledger written by one
package is read by the other.
"""

from __future__ import annotations

import abc
import json
import os
import sqlite3
import threading
import time
from typing import Dict, Iterable, List, Set

from specforge_tpu_torch.runtime.contracts import SampleRef


class MetadataStore(abc.ABC):
    @abc.abstractmethod
    def commit_sample(self, ref: SampleRef) -> bool:
        """Record a committed ref; returns False when already committed."""

    @abc.abstractmethod
    def is_committed(self, sample_id: str) -> bool: ...

    @abc.abstractmethod
    def record_ack(self, sample_ids: Iterable[str], global_step: int) -> None:
        """Durably mark ids consumed at an optimizer boundary."""

    @abc.abstractmethod
    def acked_ids(self) -> Set[str]: ...

    @abc.abstractmethod
    def durable_step(self) -> int: ...

    @abc.abstractmethod
    def committed_refs(self) -> List[SampleRef]: ...

    def committed_refs_by_ids(self, sample_ids) -> List[SampleRef]:
        """Targeted lookup (default: filter the full scan)."""
        wanted = set(sample_ids)
        return [r for r in self.committed_refs() if r.sample_id in wanted]

    def close(self) -> None:
        pass


class InMemoryMetadataStore(MetadataStore):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._committed: Dict[str, SampleRef] = {}
        self._acked: Set[str] = set()
        self._step = 0

    def commit_sample(self, ref: SampleRef) -> bool:
        with self._lock:
            if ref.sample_id in self._committed:
                return False
            self._committed[ref.sample_id] = ref
            return True

    def is_committed(self, sample_id: str) -> bool:
        with self._lock:
            return sample_id in self._committed

    def record_ack(self, sample_ids, global_step) -> None:
        with self._lock:
            self._acked.update(sample_ids)
            self._step = max(self._step, int(global_step))

    def acked_ids(self) -> Set[str]:
        with self._lock:
            return set(self._acked)

    def durable_step(self) -> int:
        with self._lock:
            return self._step

    def committed_refs(self) -> List[SampleRef]:
        with self._lock:
            return list(self._committed.values())


class NoOpMetadataStore(MetadataStore):
    def commit_sample(self, ref) -> bool:
        return True

    def is_committed(self, sample_id) -> bool:
        return False

    def record_ack(self, sample_ids, global_step) -> None:
        pass

    def acked_ids(self) -> Set[str]:
        return set()

    def durable_step(self) -> int:
        return 0

    def committed_refs(self) -> List[SampleRef]:
        return []


#: seconds a process retries the switch of a new ledger to WAL while
#: another process that opened it too holds the switch
WAL_SWITCH_TIMEOUT_S = 30.0


class SQLiteMetadataStore(MetadataStore):
    """Single-writer cross-process ledger (WAL journal)."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        # the consumer ranks open one ledger together; SQLite refuses the
        # switch to WAL at once (no busy wait: it could deadlock) to all
        # but the process that holds it, so the others retry
        deadline = time.monotonic() + WAL_SWITCH_TIMEOUT_S
        while True:
            try:
                self._conn.execute("PRAGMA journal_mode=WAL")
                break
            except sqlite3.OperationalError as e:
                if "locked" not in str(e) or time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS committed "
            "(sample_id TEXT PRIMARY KEY, ref_json TEXT NOT NULL)"
        )
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS acked (sample_id TEXT PRIMARY KEY)"
        )
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS markers "
            "(name TEXT PRIMARY KEY, value INTEGER NOT NULL)"
        )
        self._conn.commit()

    def commit_sample(self, ref: SampleRef) -> bool:
        with self._lock:
            cur = self._conn.execute(
                "INSERT OR IGNORE INTO committed (sample_id, ref_json) "
                "VALUES (?, ?)",
                (ref.sample_id, json.dumps(ref.to_json())),
            )
            self._conn.commit()
            return cur.rowcount > 0

    def is_committed(self, sample_id: str) -> bool:
        with self._lock:
            row = self._conn.execute(
                "SELECT 1 FROM committed WHERE sample_id = ?", (sample_id,)
            ).fetchone()
            return row is not None

    def record_ack(self, sample_ids, global_step) -> None:
        with self._lock:
            self._conn.executemany(
                "INSERT OR IGNORE INTO acked (sample_id) VALUES (?)",
                [(sid,) for sid in sample_ids],
            )
            self._conn.execute(
                "INSERT INTO markers (name, value) VALUES ('global_step', ?) "
                "ON CONFLICT(name) DO UPDATE SET value = "
                "MAX(value, excluded.value)",
                (int(global_step),),
            )
            self._conn.commit()

    def acked_ids(self) -> Set[str]:
        with self._lock:
            rows = self._conn.execute("SELECT sample_id FROM acked").fetchall()
            return {r[0] for r in rows}

    def durable_step(self) -> int:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM markers WHERE name = 'global_step'"
            ).fetchone()
            return int(row[0]) if row else 0

    def committed_refs(self) -> List[SampleRef]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT ref_json FROM committed ORDER BY rowid"
            ).fetchall()
            return [SampleRef.from_json(json.loads(r[0])) for r in rows]

    def committed_refs_by_ids(self, sample_ids) -> List[SampleRef]:
        ids = list(sample_ids)
        out: List[SampleRef] = []
        # chunks below SQLITE_MAX_VARIABLE_NUMBER (999 on older builds)
        for start in range(0, len(ids), 500):
            chunk = ids[start:start + 500]
            placeholders = ",".join("?" for _ in chunk)
            with self._lock:
                rows = self._conn.execute(
                    "SELECT ref_json FROM committed WHERE sample_id IN "
                    f"({placeholders}) ORDER BY rowid",
                    chunk,
                ).fetchall()
            out.extend(SampleRef.from_json(json.loads(r[0])) for r in rows)
        return out

    def close(self) -> None:
        with self._lock:
            self._conn.close()
