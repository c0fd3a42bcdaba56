"""Feature stores: the tensor plane (the read-only file store of offline runs).

Counterpart of ``FeatureStore`` and ``FileFeatureStore`` in
``specforge_tpu/runtime/data_plane/feature_store.py``. Stores speak CPU
``torch`` tensors; device placement happens after collation.
"""

from __future__ import annotations

import abc
import os
from typing import Any, Dict, Optional
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
)


class StoreError(RuntimeError):
    pass


class FeatureStore(abc.ABC):
    """Tensors cross this boundary only: callers hold metadata-only
    SampleRefs and fetch their tensors by ref."""

    @abc.abstractmethod
    def fetch(self, ref: SampleRef) -> Dict[str, torch.Tensor]: ...


class FileFeatureStore(FeatureStore):
    """Read-only store over existing ``.sft`` capture files."""

    @staticmethod
    def ref_for_file(
        path: str,
        sample_id: Optional[str] = None,
        *,
        read_specs: bool = False,
        epoch: int = 0,
    ) -> SampleRef:
        """A lazy SampleRef for one capture file: neither the header nor the
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
        return tensors
