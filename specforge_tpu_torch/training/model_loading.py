"""Frozen-input provenance for the resume contract.

Counterpart of ``frozen_input_fingerprint`` and ``draft_config_fingerprint``
in ``specforge_tpu/training/model_loading.py``: a cheap, stable identity of
the frozen target directory and of the draft config, recorded in the resume
contract so a resumed run refuses a silently different target. The
weights-only warm start (``warm_start_draft``) is not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional


def frozen_input_fingerprint(model_path: Optional[str]) -> str:
    """Hash of the config JSON plus (name, size, mtime_ns) of every weight
    shard: detects a swapped target without reading its weights."""
    if not model_path or not os.path.isdir(model_path):
        return ""
    digest = hashlib.sha256()
    config_path = os.path.join(model_path, "config.json")
    if os.path.exists(config_path):
        with open(config_path, "rb") as f:
            digest.update(f.read())
    for name in sorted(os.listdir(model_path)):
        if name.endswith((".safetensors", ".bin", ".index.json")):
            st = os.stat(os.path.join(model_path, name))
            digest.update(
                f"{name}:{st.st_size}:{st.st_mtime_ns}".encode()
            )
    return digest.hexdigest()[:16]


def draft_config_fingerprint(config_dict: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(config_dict, sort_keys=True).encode()
    ).hexdigest()[:16]
