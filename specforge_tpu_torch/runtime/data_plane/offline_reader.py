"""Offline manifest reading.

Counterpart of ``specforge_tpu/runtime/data_plane/offline_reader.py``: one
lazy ``file://`` SampleRef per ``.sft`` file, in sorted path order so every
run derives the same manifest.
"""

from __future__ import annotations

import os
from typing import List

from specforge_tpu_torch.runtime.contracts import SampleRef
from specforge_tpu_torch.runtime.data_plane.feature_store import FileFeatureStore


class OfflineManifestReader:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def list_files(self) -> List[str]:
        out: List[str] = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            out.extend(os.path.join(dirpath, name) for name in filenames
                       if name.endswith(".sft"))
        out.sort()
        return out

    def read(self) -> List[SampleRef]:
        return [FileFeatureStore.ref_for_file(path)
                for path in self.list_files()]
