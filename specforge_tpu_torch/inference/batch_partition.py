"""TargetBatchPartition: prompt tasks grouped into capture-server batches
by a token budget.

Counterpart of ``specforge_tpu/inference/batch_partition.py``: the capture
server's prefill cost scales with padded tokens, so batching amortises the
per-request overhead while the token budget bounds a padded batch. A greedy
first fit in arrival order keeps the producer deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from specforge_tpu_torch.runtime.contracts import PromptTask


def task_length(task: PromptTask) -> int:
    ids = task.payload.get("input_ids") or ()
    return len(ids)


@dataclass(frozen=True)
class TargetBatchPartition:
    max_batch_tokens: int = 8192
    max_batch_size: int = 8

    def partition(
        self, tasks: Sequence[PromptTask]
    ) -> List[List[PromptTask]]:
        """Arrival-order greedy fill: a batch closes when adding the next
        task would exceed the token budget (at the batch's padded length)
        or the size cap. Oversized single tasks get their own batch."""
        batches: List[List[PromptTask]] = []
        current: List[PromptTask] = []
        current_max = 0
        for task in tasks:
            n = task_length(task)
            new_max = max(current_max, n)
            padded = new_max * (len(current) + 1)
            if current and (
                padded > self.max_batch_tokens
                or len(current) >= self.max_batch_size
            ):
                batches.append(current)
                current, current_max = [], 0
                new_max = n
            current.append(task)
            current_max = new_max
        if current:
            batches.append(current)
        return batches
