"""Feature stores: the tensor plane.

Counterpart of ``specforge_tpu/runtime/data_plane/feature_store.py``:

- :class:`InMemoryFeatureStore` — producer-side staging: generation tags in
  URIs (refs from before a producer restart are stale), resident-byte
  accounting with a loud ``MemoryError`` above ``max_resident_bytes`` (the
  flow controller pauses upstream; the store only refuses), fetches that
  return copies, explicit release, pins and a max-hold sweep.
- :class:`FileFeatureStore` — read-only ``file://`` mode over offline feature
  files (``.sft`` native, reference ``.ckpt`` / ``.ckpt.gz``).
- :class:`SharedDirFeatureStore` — cross-process store over a shared POSIX
  directory: per-generation ``.sft`` files published by atomic rename;
  release deletes them.

Stores speak CPU ``torch`` tensors; device placement happens after
collation.
"""

from __future__ import annotations

import abc
import os
import threading
import time
from typing import Any, Dict, Iterable, Mapping, Optional
from urllib.parse import urlparse

import torch

from specforge_tpu_torch.runtime.contracts import (
    FeatureHandle,
    FeatureSpec,
    SampleRef,
)
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    load_feature_file,
    read_feature_specs,
    save_feature_file,
)


class StoreError(RuntimeError):
    pass


class StaleReferenceError(StoreError):
    """The handle's generation does not match the store's current one."""


class FeatureStore(abc.ABC):
    """put → handles; fetch by ref; release frees. Callers hold
    metadata-only SampleRefs; tensors cross this boundary only."""

    @abc.abstractmethod
    def put_sample(
        self,
        sample_id: str,
        tensors: Mapping[str, torch.Tensor],
        metadata: Optional[Mapping[str, Any]] = None,
    ) -> SampleRef: ...

    @abc.abstractmethod
    def fetch(self, ref: SampleRef) -> Dict[str, torch.Tensor]: ...

    @abc.abstractmethod
    def release(self, sample_ids: Iterable[str]) -> None: ...

    def abort(self, sample_id: str) -> None:
        self.release([sample_id])

    @abc.abstractmethod
    def health(self) -> Dict[str, Any]: ...


def _spec_of(name: str, t: torch.Tensor) -> FeatureSpec:
    return FeatureSpec(name=name, shape=tuple(t.shape),
                       dtype=str(t.dtype).removeprefix("torch."))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class InMemoryFeatureStore(FeatureStore):
    def __init__(
        self,
        *,
        max_resident_bytes: Optional[int] = None,
        generation: int = 0,
    ) -> None:
        self._lock = threading.Lock()
        self._data: Dict[str, Dict[str, torch.Tensor]] = {}
        self._bytes: Dict[str, int] = {}
        self.resident_bytes = 0
        self.max_resident_bytes = max_resident_bytes
        self.generation = generation
        self._put_count = 0
        self._fetch_count = 0
        self._release_count = 0
        self._touched: Dict[str, float] = {}
        self._pinned: set = set()

    def put_sample(self, sample_id, tensors, metadata=None) -> SampleRef:
        tensors = {k: torch.as_tensor(v) for k, v in tensors.items()}
        nbytes = sum(_nbytes(t) for t in tensors.values())
        with self._lock:
            # a re-put of a resident sample id is a no-op
            if sample_id not in self._data:
                if (self.max_resident_bytes is not None
                        and self.resident_bytes + nbytes
                        > self.max_resident_bytes):
                    raise MemoryError(
                        f"feature store over budget: resident="
                        f"{self.resident_bytes} + incoming={nbytes} > max="
                        f"{self.max_resident_bytes}; producer flow control "
                        "should have paused upstream"
                    )
                self._data[sample_id] = {k: t.contiguous()
                                         for k, t in tensors.items()}
                self._bytes[sample_id] = nbytes
                self.resident_bytes += nbytes
                self._put_count += 1
            self._touched[sample_id] = time.monotonic()
        features = {
            name: FeatureHandle(
                uri=f"mem://{sample_id}/{name}.g{self.generation}",
                spec=_spec_of(name, t),
            )
            for name, t in tensors.items()
        }
        return SampleRef(sample_id=sample_id, features=features,
                         metadata=dict(metadata or {}))

    def _check_generation(self, handle: FeatureHandle) -> None:
        parts = handle.uri.rsplit(".g", 1)
        if (len(parts) == 2 and parts[1].isdigit()
                and int(parts[1]) != self.generation):
            raise StaleReferenceError(
                f"stale handle {handle.uri} (store generation "
                f"{self.generation})"
            )

    def fetch(self, ref: SampleRef) -> Dict[str, torch.Tensor]:
        for handle in ref.features.values():
            self._check_generation(handle)
        with self._lock:
            if ref.sample_id not in self._data:
                raise KeyError(f"sample {ref.sample_id} not in store")
            out = {k: t.clone() for k, t in self._data[ref.sample_id].items()}
            self._fetch_count += 1
            self._touched[ref.sample_id] = time.monotonic()
        return out

    def _free_locked(self, sample_id: str) -> None:
        if sample_id in self._data:
            self.resident_bytes -= self._bytes.pop(sample_id, 0)
            del self._data[sample_id]
            self._touched.pop(sample_id, None)
            self._pinned.discard(sample_id)
            self._release_count += 1

    def release(self, sample_ids: Iterable[str]) -> None:
        with self._lock:
            for sid in sample_ids:
                self._free_locked(sid)

    def pin(self, sample_ids: Iterable[str]) -> None:
        with self._lock:
            self._pinned.update(sample_ids)

    def unpin(self, sample_ids: Iterable[str]) -> None:
        with self._lock:
            self._pinned.difference_update(sample_ids)

    def gc_sweep(self, max_age_seconds: float) -> int:
        """Free unpinned samples untouched (no put or fetch) for longer than
        ``max_age_seconds``: leaked puts of crashed producers."""
        cutoff = time.monotonic() - max_age_seconds
        removed = 0
        with self._lock:
            for sid in list(self._data):
                if (sid not in self._pinned
                        and self._touched.get(sid, 0.0) <= cutoff):
                    self._free_locked(sid)
                    removed += 1
        return removed

    def health(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "backend": "memory",
                "resident_bytes": self.resident_bytes,
                "resident_samples": len(self._data),
                "puts": self._put_count,
                "fetches": self._fetch_count,
                "releases": self._release_count,
                "generation": self.generation,
            }


class FileFeatureStore(FeatureStore):
    """Read-only store over existing feature files (offline training)."""

    def __init__(self) -> None:
        self._fetch_count = 0

    def put_sample(self, sample_id, tensors, metadata=None) -> SampleRef:
        raise StoreError("FileFeatureStore is read-only")

    @staticmethod
    def ref_for_file(
        path: str,
        sample_id: Optional[str] = None,
        *,
        read_specs: bool = False,
        epoch: int = 0,
    ) -> SampleRef:
        """A lazy SampleRef for one feature file: neither the header nor the
        tensor bytes are read unless ``read_specs`` (and the file is an
        ``.sft``; a ``.ckpt`` ref keeps the placeholder handle)."""
        path = os.path.abspath(path)
        if sample_id is None:
            base = os.path.basename(path)
            for suffix in (".sft", ".ckpt.gz", ".ckpt"):
                if base.endswith(suffix):
                    base = base[:-len(suffix)]
                    break
            sample_id = base
        metadata: Dict[str, Any] = {}
        if read_specs and path.endswith(".sft"):
            specs, meta = read_feature_specs(path)
            metadata.update(meta)
            features = {
                name: FeatureHandle(uri=f"file://{path}#{name}", spec=spec)
                for name, spec in sorted(specs.items())  # as safetensors lists them
            }
        else:
            features = {
                "__file__": FeatureHandle(
                    uri=f"file://{path}",
                    spec=FeatureSpec(name="__file__", shape=(), dtype="uint8"),
                )
            }
        return SampleRef(sample_id=sample_id, features=features, epoch=epoch,
                         metadata=metadata)

    def fetch(self, ref: SampleRef) -> Dict[str, torch.Tensor]:
        handle = next(iter(ref.features.values()))
        parsed = urlparse(handle.uri)
        if parsed.scheme != "file":
            raise StoreError(f"FileFeatureStore got non-file uri {handle.uri}")
        tensors, _meta = load_feature_file(parsed.path)
        self._fetch_count += 1
        return tensors

    def release(self, sample_ids: Iterable[str]) -> None:
        pass  # read-only: offline files outlive training

    def health(self) -> Dict[str, Any]:
        return {"backend": "file", "fetches": self._fetch_count}


class SharedDirFeatureStore(FeatureStore):
    """Cross-process store over a shared POSIX directory.

    The producer publishes ``{sample_id}.g{generation}.sft`` by atomic
    rename; consumers fetch by ref; release (the durable ack) deletes the
    file. The generation in the file name rejects refs of a dead producer's
    previous life."""

    def __init__(self, root: str, *, generation: int = 0) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.generation = generation
        self._put_count = 0
        self._fetch_count = 0
        self._release_count = 0

    def _path(self, sample_id: str) -> str:
        return os.path.join(self.root, f"{sample_id}.g{self.generation}.sft")

    def put_sample(self, sample_id, tensors, metadata=None) -> SampleRef:
        tensors = {k: torch.as_tensor(v) for k, v in tensors.items()}
        path = self._path(sample_id)
        save_feature_file(path, tensors,
                          {k: str(v) for k, v in (metadata or {}).items()})
        self._put_count += 1
        features = {
            name: FeatureHandle(uri=f"file://{path}#{name}",
                                spec=_spec_of(name, t))
            for name, t in tensors.items()
        }
        return SampleRef(sample_id=sample_id, features=features,
                         metadata=dict(metadata or {}))

    def fetch(self, ref: SampleRef) -> Dict[str, torch.Tensor]:
        path = self._path(ref.sample_id)
        if not os.path.exists(path):
            # the ref may carry another generation: try its own path
            path = urlparse(next(iter(ref.features.values())).uri).path
            if not os.path.exists(path):
                raise StaleReferenceError(
                    f"sample {ref.sample_id} not present in {self.root}"
                )
        tensors, _ = load_feature_file(path)
        self._fetch_count += 1
        return tensors

    def release(self, sample_ids: Iterable[str]) -> None:
        for sid in sample_ids:
            try:
                os.remove(self._path(sid))
                self._release_count += 1
            except FileNotFoundError:
                pass

    def health(self) -> Dict[str, Any]:
        return {
            "backend": "shared_dir",
            "root": self.root,
            "resident_samples": len(
                [n for n in os.listdir(self.root) if n.endswith(".sft")]
            ),
            "puts": self._put_count,
            "fetches": self._fetch_count,
            "releases": self._release_count,
            "generation": self.generation,
        }
