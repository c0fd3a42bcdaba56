"""Offline manifest reading and deterministic per-rank sharding.

Counterpart of ``specforge_tpu/runtime/data_plane/offline_reader.py``: one
lazy ``file://`` SampleRef per feature file (``.sft``, or the reference's
``.ckpt`` / ``.ckpt.gz``), no tensor or header read, in sorted path order so
every rank derives the same manifest; :func:`shard_refs` then takes a
strided shard of it.
"""

from __future__ import annotations

import os
from typing import List, Sequence

from specforge_tpu_torch.runtime.contracts import SampleRef
from specforge_tpu_torch.runtime.data_plane.feature_store import FileFeatureStore

FEATURE_SUFFIXES = (".sft", ".ckpt", ".ckpt.gz")


class OfflineManifestReader:
    def __init__(self, root: str, *, suffixes: Sequence[str] = FEATURE_SUFFIXES):
        self.root = os.path.abspath(root)
        self.suffixes = tuple(suffixes)

    def list_files(self) -> List[str]:
        out: List[str] = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            out.extend(os.path.join(dirpath, name) for name in filenames
                       if name.endswith(self.suffixes))
        out.sort()
        return out

    def read(self, epoch: int = 0) -> List[SampleRef]:
        return [FileFeatureStore.ref_for_file(path, epoch=epoch)
                for path in self.list_files()]


def shard_refs(
    refs: Sequence[SampleRef],
    rank: int,
    world_size: int,
    *,
    drop_remainder: bool = True,
) -> List[SampleRef]:
    """Deterministic strided shard; with ``drop_remainder`` every rank gets
    the same count (floor(n / world)), so collectives stay in lockstep."""
    if world_size <= 1:
        return list(refs)
    if drop_remainder:
        refs = refs[:(len(refs) // world_size) * world_size]
    return list(refs[rank::world_size])
