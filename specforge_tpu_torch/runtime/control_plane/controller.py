"""DataFlowController: metadata-only prompt and sample lifecycle.

Counterpart of ``specforge_tpu/runtime/control_plane/controller.py``:
prompt ingest → lease (attempt-capped) → sample commit (deduped through
the MetadataStore) → durable ack at optimizer boundaries (store release of
the acked tensors) → reconcile on restart (requeue the unacked tail).
Every ingress runs :func:`assert_no_tensors`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

from specforge_tpu_torch.runtime.contracts import (
    PromptTask,
    SampleRef,
    assert_no_tensors,
)
from specforge_tpu_torch.runtime.control_plane.metadata_store import (
    InMemoryMetadataStore,
    MetadataStore,
)


class PromptExhaustedError(RuntimeError):
    """A prompt exceeded its attempt cap and is poisoned."""


@dataclass
class _PromptState:
    task: PromptTask
    leased_by: Optional[str] = None
    lease_time: float = 0.0
    attempts: int = 0
    done: bool = False
    poisoned: bool = False


class DataFlowController:
    def __init__(
        self,
        metadata_store: Optional[MetadataStore] = None,
        *,
        max_attempts: int = 3,
        release_fn: Optional[Callable[[List[str]], None]] = None,
    ) -> None:
        self.store = metadata_store or InMemoryMetadataStore()
        self.max_attempts = max_attempts
        self.release_fn = release_fn
        self._lock = threading.Lock()
        self._prompts: Dict[str, _PromptState] = {}
        self._order: List[str] = []
        self._committed_count = 0
        self._acked_count = 0

    # --- prompt lifecycle ------------------------------------------------
    def ingest_prompts(self, tasks: Iterable[PromptTask]) -> int:
        n = 0
        with self._lock:
            for task in tasks:
                assert_no_tensors(task, where=f"prompt {task.prompt_id}")
                if task.prompt_id in self._prompts:
                    continue
                self._prompts[task.prompt_id] = _PromptState(task=task)
                self._order.append(task.prompt_id)
                n += 1
        return n

    def lease_prompt_tasks(self, worker_id: str,
                           limit: int = 1) -> List[PromptTask]:
        leased: List[PromptTask] = []
        with self._lock:
            for pid in self._order:
                if len(leased) >= limit:
                    break
                state = self._prompts[pid]
                if state.done or state.poisoned or state.leased_by:
                    continue
                state.leased_by = worker_id
                state.lease_time = time.monotonic()
                state.attempts += 1
                leased.append(state.task)
        return leased

    def complete_prompt(self, prompt_id: str) -> None:
        with self._lock:
            state = self._prompts.get(prompt_id)
            if state is not None:
                state.done = True
                state.leased_by = None

    def fail_prompt(self, prompt_id: str, error: str = "") -> None:
        """Release the lease; poison after ``max_attempts``."""
        with self._lock:
            state = self._prompts.get(prompt_id)
            if state is None:
                return
            state.leased_by = None
            if state.attempts >= self.max_attempts:
                state.poisoned = True

    # --- sample lifecycle ------------------------------------------------
    def commit_samples(self, refs: Iterable[SampleRef]) -> List[SampleRef]:
        """Dedup-commit; returns the refs that were newly committed."""
        fresh: List[SampleRef] = []
        for ref in refs:
            assert_no_tensors(ref, where=f"sample {ref.sample_id}")
            if self.store.commit_sample(ref):
                fresh.append(ref)
                with self._lock:
                    self._committed_count += 1
        return fresh

    def ack_train_refs(self, sample_ids: List[str], global_step: int) -> None:
        """Optimizer-durable ack: the ledger marker first, then the store
        release."""
        self.store.record_ack(sample_ids, global_step)
        with self._lock:
            self._acked_count += len(sample_ids)
        if self.release_fn is not None:
            self.release_fn(list(sample_ids))

    def reconcile_on_restart(self) -> List[SampleRef]:
        """Committed but unacked refs, in commit order: the redelivery
        tail."""
        acked = self.store.acked_ids()
        return [ref for ref in self.store.committed_refs()
                if ref.sample_id not in acked]

    # --- observability ---------------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._lock:
            pending = sum(1 for s in self._prompts.values()
                          if not s.done and not s.poisoned)
            poisoned = sum(1 for s in self._prompts.values() if s.poisoned)
            return {
                "prompts_total": len(self._prompts),
                "prompts_pending": pending,
                "prompts_poisoned": poisoned,
                "samples_committed": self._committed_count,
                "samples_acked": self._acked_count,
                "durable_step": self.store.durable_step(),
            }
