"""FeatureDataLoader: refs → materialize → collate → TrainBatch.

Counterpart of ``specforge_tpu/runtime/data_plane/feature_dataloader.py``
(the offline, list-of-refs mode): materialization (the store fetch and an
optional per-sample ``transform(tensors, ref)``) runs on background threads
with ordered handoff, so training sees a deterministic sequence; an
incomplete final batch is dropped. ``seek`` positions the next pass after a
number of samples, for a mid-epoch resume. Batches stay on the host; the
strategy moves them to its device.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch

from specforge_tpu_torch.runtime.contracts import SampleRef, TrainBatch
from specforge_tpu_torch.runtime.data_plane.feature_store import FeatureStore

Transform = Callable[[Dict[str, torch.Tensor], SampleRef],
                     Dict[str, torch.Tensor]]
Collate = Callable[..., TrainBatch]


class FeatureDataLoader:
    def __init__(
        self,
        store: FeatureStore,
        collate: Collate,
        *,
        refs: Sequence[SampleRef],
        batch_size: int = 1,
        transform: Optional[Transform] = None,
        num_workers: int = 2,
        prefetch_batches: int = 2,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.store = store
        self.collate = collate
        self.refs = list(refs)
        self.batch_size = batch_size
        self.transform = transform
        self.num_workers = max(0, num_workers)
        #: batches fetched ahead of the one being collated
        self.prefetch_batches = max(1, prefetch_batches)
        self.metadata = dict(metadata or {})
        self._start_index = 0  # in samples (seek/resume)

    def seek(self, samples_consumed: int) -> None:
        """Start the next pass after ``samples_consumed`` samples."""
        self._start_index = samples_consumed % max(len(self.refs), 1)

    def __len__(self) -> int:
        return (len(self.refs) - self._start_index) // self.batch_size

    def _batched_refs(self) -> Iterator[List[SampleRef]]:
        start = self._start_index
        n = (len(self.refs) - start) // self.batch_size * self.batch_size
        for i in range(start, start + n, self.batch_size):
            yield self.refs[i:i + self.batch_size]

    def __iter__(self) -> Iterator[TrainBatch]:
        if self.num_workers == 0:
            for ref_batch in self._batched_refs():
                yield self._collate_batch(
                    ref_batch, [self._materialize(r) for r in ref_batch]
                )
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            for ref_batch in self._batched_refs():
                pending.append(
                    (ref_batch, [pool.submit(self._materialize, r)
                                 for r in ref_batch])
                )
                if len(pending) > self.prefetch_batches:
                    yield self._collate_ready(*pending.pop(0))
            while pending:
                yield self._collate_ready(*pending.pop(0))

    def _materialize(self, ref: SampleRef) -> Dict[str, torch.Tensor]:
        tensors = self.store.fetch(ref)
        if self.transform is not None:
            tensors = self.transform(tensors, ref)
        return tensors

    def _collate_ready(self, ref_batch, futures) -> TrainBatch:
        return self._collate_batch(ref_batch, [f.result() for f in futures])

    def _collate_batch(self, ref_batch, samples) -> TrainBatch:
        metadata = dict(self.metadata)
        for ref in ref_batch:
            metadata.update(
                {k: v for k, v in ref.metadata.items() if k not in metadata}
            )
        return self.collate(
            samples,
            sample_ids=[r.sample_id for r in ref_batch],
            metadata=metadata,
        )
