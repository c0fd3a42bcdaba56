"""FeatureDataLoader: refs → materialize → collate → TrainBatch.

Counterpart of ``specforge_tpu/runtime/data_plane/feature_dataloader.py``.
The source is exactly one of a re-iterable list of refs (offline; ``seek``
positions the next pass after a number of samples, for a mid-epoch resume)
or a consume-once ``ref_queue`` (streaming, online runs; ``None`` ends the
stream). Materialization (the store fetch and an optional per-sample
``transform(tensors, ref)``) runs on background threads with ordered
handoff, so training sees a deterministic sequence; an incomplete final
batch is dropped. Batches stay on the host; the strategy moves them to its
device.
"""

from __future__ import annotations

import queue as queue_mod
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
        refs: Optional[Sequence[SampleRef]] = None,
        ref_queue: Optional["queue_mod.Queue"] = None,
        batch_size: int = 1,
        transform: Optional[Transform] = None,
        num_workers: int = 2,
        prefetch_batches: int = 2,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> None:
        if (refs is None) == (ref_queue is None):
            raise ValueError("provide exactly one of refs / ref_queue")
        self.store = store
        self.collate = collate
        self.refs = list(refs) if refs is not None else None
        self.ref_queue = ref_queue
        self.batch_size = batch_size
        self.transform = transform
        self.num_workers = max(0, num_workers)
        #: batches fetched ahead of the one being collated
        self.prefetch_batches = max(1, prefetch_batches)
        self.metadata = dict(metadata or {})
        self._start_index = 0  # in samples (seek/resume)

    @property
    def supports_seek(self) -> bool:
        return self.refs is not None

    def seek(self, samples_consumed: int) -> None:
        """Start the next pass after ``samples_consumed`` samples."""
        if self.refs is None:
            raise ValueError("seek is only supported in refs (offline) mode")
        self._start_index = samples_consumed % max(len(self.refs), 1)

    def __len__(self) -> int:
        if self.refs is None:
            raise TypeError("streaming loader has no length")
        return (len(self.refs) - self._start_index) // self.batch_size

    def _ref_stream(self) -> Iterator[SampleRef]:
        if self.refs is not None:
            yield from self.refs[self._start_index:]
            return
        while True:
            item = self.ref_queue.get()
            if item is None:  # the stream is closed
                return
            yield item

    def _batched_refs(self) -> Iterator[List[SampleRef]]:
        buf: List[SampleRef] = []
        for ref in self._ref_stream():
            buf.append(ref)
            if len(buf) == self.batch_size:
                yield buf
                buf = []

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
