"""RefDistributor: the consumer side's single channel reader.

Counterpart of ``specforge_tpu/runtime/data_plane/ref_distributor.py``:
data-parallel rank 0 alone reads the producer channel, commits refs through
the controller (SQLite ledger dedup), releases whole optimizer windows
(``window = world_size × batch × accum`` samples, drop-last) and splits each
window over per-rank JSONL inboxes. A producer failure's ``failed``
sentinel goes into every inbox so all ranks fail together.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from specforge_tpu_torch.runtime.contracts import SampleRef
from specforge_tpu_torch.runtime.control_plane.controller import (
    DataFlowController,
)
from specforge_tpu_torch.runtime.data_plane.streaming_ref_channel import (
    StreamingRefChannel,
)


class InboxChannel:
    """Per-rank append-only JSONL inbox with byte-offset idempotent reads."""

    def __init__(self, inbox_dir: str, rank: int) -> None:
        os.makedirs(inbox_dir, exist_ok=True)
        self.path = os.path.join(inbox_dir, f"rank{rank}.jsonl")
        self._offset = 0
        self.consumed = 0

    def append(self, records: List[dict]) -> None:
        with open(self.path, "a") as f:
            for record in records:
                f.write(json.dumps(record) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def poll(self) -> Tuple[List[SampleRef], bool, Optional[str]]:
        refs: List[SampleRef] = []
        closed = False
        failure: Optional[str] = None
        if not os.path.exists(self.path):
            return refs, closed, failure
        with open(self.path) as f:
            f.seek(self._offset)
            while True:
                start = f.tell()
                line = f.readline()
                if not line or not line.endswith("\n"):
                    self._offset = start
                    break
                self._offset = f.tell()
                record = json.loads(line)
                kind = record.pop("kind", "ref")
                if kind == "ref":
                    refs.append(SampleRef.from_json(record))
                elif kind == "closed":
                    closed = True
                elif kind == "failed":
                    failure = record.get("error", "producer failed")
        self.consumed += len(refs)
        return refs, closed, failure


class RefDistributor:
    def __init__(
        self,
        channel: StreamingRefChannel,
        controller: DataFlowController,
        inbox_dir: str,
        *,
        world_size: int,
        window_samples: int,
    ) -> None:
        """``window_samples``: global samples per optimizer window
        (world × batch × accum) — refs release to inboxes only in whole
        windows (drop-last)."""
        self.channel = channel
        self.controller = controller
        self.world_size = world_size
        self.window_samples = window_samples
        if window_samples % world_size != 0:
            raise ValueError(
                f"window_samples {window_samples} must divide by world_size "
                f"{world_size}"
            )
        self.inboxes = [InboxChannel(inbox_dir, r) for r in range(world_size)]
        self._staged: List[SampleRef] = []
        self._closed = False
        self._distributed = 0
        # resume: requeue the committed-but-unacked tail before new refs
        self._staged.extend(self.controller.reconcile_on_restart())

    def pump(self) -> int:
        """Poll the channel, commit, release complete windows; returns the
        number of refs distributed this call."""
        refs, closed, failure = self.channel.poll()
        if failure:
            self._fan_out_failure(failure)
            raise RuntimeError(f"producer failed: {failure}")
        fresh = self.controller.commit_samples(refs)
        self._staged.extend(fresh)

        released = 0
        while len(self._staged) >= self.window_samples:
            window = self._staged[: self.window_samples]
            self._staged = self._staged[self.window_samples:]
            per_rank = self.window_samples // self.world_size
            for rank, inbox in enumerate(self.inboxes):
                shard = window[rank * per_rank:(rank + 1) * per_rank]
                inbox.append([{"kind": "ref", **r.to_json()} for r in shard])
            released += self.window_samples
            self._distributed += self.window_samples

        if closed and not self._closed:
            # drop-last: the incomplete tail is never distributed
            for inbox in self.inboxes:
                inbox.append([{"kind": "closed"}])
            self._closed = True
        return released

    def forward_consumed(self, count: Optional[int] = None) -> None:
        """Report inbox consumption back to the source channel counter."""
        if count is None:
            count = self._distributed
        already = self.channel.consumed_count()
        if count > already:
            self.channel.mark_consumed(count - already)

    def _fan_out_failure(self, error: str) -> None:
        for inbox in self.inboxes:
            inbox.append([{"kind": "failed", "error": error}])

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def staged_count(self) -> int:
        return len(self._staged)
