"""DPAckController: the durable ack as a cross-rank collective.

Counterpart of ``specforge_tpu/runtime/control_plane/dp_ack.py``. Every
data-parallel rank contributes the sample ids it consumed this optimizer
step; rank 0 is the single writer that records the union into the ledger
and drives the ack sink. The exchange goes through a shared directory
(JSON, not tensors). Per step N, under ``ack_dir``:

    rank r writes  step{N}.rank{r}.json   (atomic rename)
    rank 0 polls until all world_size files exist, acks the union, then
    writes step{N}.done; the other ranks wait for the .done marker.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional


class DPAckController:
    def __init__(
        self,
        ack_dir: str,
        *,
        rank: int,
        world_size: int,
        ack_fn: Optional[Callable[[List[str], int], None]] = None,
        timeout_s: float = 300.0,
        poll_s: float = 0.05,
    ) -> None:
        self.ack_dir = os.path.abspath(ack_dir)
        os.makedirs(self.ack_dir, exist_ok=True)
        self.rank = rank
        self.world_size = world_size
        self.ack_fn = ack_fn
        self.timeout_s = timeout_s
        self.poll_s = poll_s

    def _path(self, step: int, rank: int) -> str:
        return os.path.join(self.ack_dir, f"step{step}.rank{rank}.json")

    def _done_path(self, step: int) -> str:
        return os.path.join(self.ack_dir, f"step{step}.done")

    def ack_train_refs(self, sample_ids: List[str], step: int) -> List[str]:
        """Collective: the union of all ranks' ids (rank 0 also runs the
        ack sink before releasing the others)."""
        tmp = self._path(step, self.rank) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(list(sample_ids), f)
        os.replace(tmp, self._path(step, self.rank))
        if self.rank == 0:
            union = self._gather(step)
            if self.ack_fn is not None:
                self.ack_fn(union, step)
            with open(self._done_path(step) + ".tmp", "w") as f:
                json.dump(union, f)
            os.replace(self._done_path(step) + ".tmp", self._done_path(step))
            return union
        return self._wait_done(step)

    def _gather(self, step: int) -> List[str]:
        deadline = time.monotonic() + self.timeout_s
        union: List[str] = []
        seen = set()
        pending = set(range(self.world_size))
        while pending:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"dp ack step {step}: missing ranks {sorted(pending)}")
            for r in sorted(pending):
                path = self._path(step, r)
                if os.path.exists(path):
                    with open(path) as f:
                        for sid in json.load(f):
                            if sid not in seen:
                                seen.add(sid)
                                union.append(sid)
                    pending.discard(r)
            if pending:
                time.sleep(self.poll_s)
        return union

    def _wait_done(self, step: int) -> List[str]:
        deadline = time.monotonic() + self.timeout_s
        path = self._done_path(step)
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"dp ack step {step}: no done marker")
            time.sleep(self.poll_s)
        with open(path) as f:
            return json.load(f)

    def cleanup(self, keep_last: int = 2) -> None:
        """Drop the exchange files older than the newest ``keep_last``
        steps."""
        steps = set()
        for name in os.listdir(self.ack_dir):
            if name.startswith("step") and (".rank" in name
                                            or name.endswith(".done")):
                try:
                    steps.add(int(name[4:].split(".")[0]))
                except ValueError:
                    pass
        for step in sorted(steps)[:-keep_last] if len(steps) > keep_last \
                else []:
            for name in list(os.listdir(self.ack_dir)):
                if name.startswith(f"step{step}."):
                    try:
                        os.remove(os.path.join(self.ack_dir, name))
                    except FileNotFoundError:
                        pass
