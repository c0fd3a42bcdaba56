"""RolloutWorker: the producer loop.

Counterpart of ``specforge_tpu/inference/rollout_worker.py``: lease
prompts → features from an injected source (a target-forward capture, the
HTTP capture-server adapter, or a test stub) → verification against the
CaptureConfig → store put → controller commit → channel publish, with the
flow-control pause between rounds and a worker dropped after consecutive
failures (its prompts re-leased).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from specforge_tpu_torch.inference.capture import (
    CaptureConfig,
    verify_capture,
)
from specforge_tpu_torch.runtime.contracts import PromptTask, SampleRef
from specforge_tpu_torch.runtime.control_plane.controller import (
    DataFlowController,
)
from specforge_tpu_torch.runtime.control_plane.flow_control import (
    ProducerFlowControl,
)

logger = logging.getLogger("specforge_tpu_torch.rollout")

# feature_source(task) -> list of (sample_id_suffix, tensors, metadata)
FeatureSource = Callable[
    [PromptTask], List[tuple]
]


@dataclass
class WorkerHealth:
    processed: int = 0
    failed: int = 0
    consecutive_failures: int = 0
    dropped: bool = False


class RolloutWorker:
    def __init__(
        self,
        worker_id: str,
        *,
        controller: DataFlowController,
        store=None,
        feature_source: Optional[FeatureSource] = None,
        ref_source: Optional[Callable[[PromptTask], List[SampleRef]]] = None,
        batch_ref_source: Optional[
            Callable[[List[PromptTask]], List[SampleRef]]
        ] = None,
        batch_partition=None,
        capture_config: Optional[CaptureConfig] = None,
        publish_fn: Optional[Callable[[List[SampleRef]], None]] = None,
        flow_control: Optional[ProducerFlowControl] = None,
        max_consecutive_failures: int = 5,
        lease_limit: int = 1,
    ) -> None:
        """Exactly one of ``feature_source`` (tensors → this process puts them
        into ``store``), ``ref_source`` (a capture server wrote tensors
        server-side; refs come back ready), or ``batch_ref_source`` (the
        token-budget-batched variant, paired with ``batch_partition``) must
        be given."""
        n_sources = sum(
            s is not None
            for s in (feature_source, ref_source, batch_ref_source)
        )
        if n_sources != 1:
            raise ValueError(
                "provide exactly one of feature_source / ref_source / "
                "batch_ref_source"
            )
        if batch_ref_source is not None and batch_partition is None:
            from specforge_tpu_torch.inference.batch_partition import (
                TargetBatchPartition,
            )

            batch_partition = TargetBatchPartition()
        if feature_source is not None and store is None:
            raise ValueError("feature_source mode requires a store")
        self.worker_id = worker_id
        self.controller = controller
        self.store = store
        self.feature_source = feature_source
        self.ref_source = ref_source
        self.batch_ref_source = batch_ref_source
        self.batch_partition = batch_partition
        self.capture_config = capture_config
        self.publish_fn = publish_fn
        self.flow_control = flow_control
        self.max_consecutive_failures = max_consecutive_failures
        self.lease_limit = lease_limit
        self.health = WorkerHealth()

    def step(self) -> int:
        """One lease→capture→publish round; returns samples produced."""
        if self.health.dropped:
            return 0
        if self.flow_control is not None and self.flow_control.paused:
            return 0
        tasks = self.controller.lease_prompt_tasks(
            self.worker_id, limit=self.lease_limit
        )
        produced = 0
        if self.batch_ref_source is not None:
            for batch in self.batch_partition.partition(tasks):
                try:
                    produced += self._process_batch(batch)
                    self.health.processed += len(batch)
                    self.health.consecutive_failures = 0
                except Exception as exc:  # noqa: BLE001 — survive bad batches
                    self.health.failed += len(batch)
                    self.health.consecutive_failures += 1
                    logger.warning(
                        "worker %s failed batch of %d: %s",
                        self.worker_id, len(batch), exc,
                    )
                    for task in batch:
                        self.controller.fail_prompt(task.prompt_id, str(exc))
                    if (
                        self.health.consecutive_failures
                        >= self.max_consecutive_failures
                    ):
                        self.health.dropped = True
                        break
            return produced
        for task in tasks:
            try:
                produced += self._process(task)
                self.health.processed += 1
                self.health.consecutive_failures = 0
            except Exception as exc:  # noqa: BLE001 — worker survives bad prompts
                self.health.failed += 1
                self.health.consecutive_failures += 1
                logger.warning(
                    "worker %s failed prompt %s: %s",
                    self.worker_id, task.prompt_id, exc,
                )
                self.controller.fail_prompt(task.prompt_id, str(exc))
                if (
                    self.health.consecutive_failures
                    >= self.max_consecutive_failures
                ):
                    self.health.dropped = True
                    logger.error(
                        "worker %s dropped after %d consecutive failures",
                        self.worker_id, self.health.consecutive_failures,
                    )
                    break
        return produced

    def _process_batch(self, batch: List[PromptTask]) -> int:
        refs = self.batch_ref_source(batch)
        committed = self.controller.commit_samples(refs)
        if self.publish_fn is not None and committed:
            self.publish_fn(committed)
        if self.flow_control is not None and committed:
            self.flow_control.on_published(
                len(committed), sum(r.nbytes for r in committed)
            )
        for task in batch:
            self.controller.complete_prompt(task.prompt_id)
        return len(committed)

    def _process(self, task: PromptTask) -> int:
        if self.ref_source is not None:
            refs = self.ref_source(task)
            committed = self.controller.commit_samples(refs)
            if self.publish_fn is not None and committed:
                self.publish_fn(committed)
            if self.flow_control is not None and committed:
                self.flow_control.on_published(
                    len(committed), sum(r.nbytes for r in committed)
                )
            self.controller.complete_prompt(task.prompt_id)
            return len(committed)

        outputs = self.feature_source(task)
        refs: List[SampleRef] = []
        total_bytes = 0
        for suffix, tensors, metadata in outputs:
            if self.capture_config is not None:
                verify_capture(tensors, self.capture_config)
            sample_id = f"{task.prompt_id}/{suffix}" if suffix else task.prompt_id
            ref = self.store.put_sample(sample_id, tensors, metadata)
            ref = SampleRef(
                sample_id=ref.sample_id,
                features=ref.features,
                prompt_id=task.prompt_id,
                epoch=task.epoch,
                metadata=ref.metadata,
            )
            refs.append(ref)
            total_bytes += ref.nbytes
        committed = self.controller.commit_samples(refs)
        if self.publish_fn is not None and committed:
            self.publish_fn(committed)
        if self.flow_control is not None and committed:
            self.flow_control.on_published(len(committed), total_bytes)
        self.controller.complete_prompt(task.prompt_id)
        return len(committed)

    def drain(self, poll_interval: float = 0.0) -> int:
        """Run until no prompts remain leasable; returns total produced.

        With ``poll_interval > 0`` the worker waits out flow-control pauses;
        otherwise a pause ends the drain (the caller owns the outer loop).
        """
        total = 0
        while not self.health.dropped:
            if self.flow_control is not None and self.flow_control.paused:
                if not poll_interval:
                    break
                time.sleep(poll_interval)
                continue
            pending_before = self.controller.status()["prompts_pending"]
            produced = self.step()
            total += produced
            pending_after = self.controller.status()["prompts_pending"]
            if pending_after == 0:
                break
            if produced == 0 and pending_after == pending_before:
                break  # nothing leasable by this worker
        return total
