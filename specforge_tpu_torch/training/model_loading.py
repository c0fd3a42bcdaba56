"""Draft warm start and frozen-input provenance.

Counterpart of ``specforge_tpu/training/model_loading.py``:

- :func:`warm_start_draft` loads draft weights (only: no optimizer state, no
  schedule; a warm start, not a resume) into a freshly built training
  model, from an exported draft directory (``model.safetensors``, HF or
  SGLang layout, through ``models/model_loading.py``) or from a port run or
  checkpoint directory (``state/state.pt``).
- :func:`frozen_input_fingerprint` and :func:`draft_config_fingerprint`: a
  cheap, stable identity of the frozen target directory and of the draft
  config, recorded in the resume contract so a resumed run refuses a
  silently different target.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from specforge_tpu_torch.models.model_loading import draft_state_from_export
from specforge_tpu_torch.runtime.data_plane.feature_file import load_feature_file
from specforge_tpu_torch.training.checkpoint import CheckpointManager


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


def _checkpoint_draft_state(path: str, expected: Dict[str, torch.Tensor],
                            draft_key: str) -> Dict[str, torch.Tensor]:
    """The draft's tensors of a port run or step directory: its saved
    masters (under ``draft_key`` when the run nested them) that the draft
    has, and the vocab-mapping buffers."""
    payload = CheckpointManager.load_state(
        CheckpointManager.resolve_step_dir(path))
    out: Dict[str, torch.Tensor] = {}
    for group in ("params", "buffers"):
        saved = payload.get(group) or {}
        prefix = f"{draft_key}."
        if any(k.startswith(prefix) for k in saved):
            saved = {k[len(prefix):]: v for k, v in saved.items()
                     if k.startswith(prefix)}
        for name, value in saved.items():
            if group == "buffers" and name not in ("t2d", "d2t"):
                continue
            if name not in expected:
                continue
            want = expected[name]
            if tuple(value.shape) != tuple(want.shape):
                raise ValueError(f"warm start shape mismatch at {name}")
            out[name] = value.to(want.dtype)
    return out


@torch.no_grad()
def warm_start_draft(model: nn.Module, checkpoint_path: str, *,
                     draft_key: str = "draft_model") -> int:
    """Load draft weights into ``model`` (the training model, whose draft is
    its ``draft_key`` submodule, or a draft) in place, before any optimizer
    state exists. ``checkpoint_path``: an exported draft directory holding
    ``model.safetensors`` (torch-convention keys), or a port run or step
    directory. Parameters the source lacks keep their initial values.
    Returns the number of tensors loaded."""
    if not os.path.isdir(checkpoint_path):
        raise FileNotFoundError(
            f"warm_start_draft: {checkpoint_path!r} is not a directory (an "
            "exported draft with model.safetensors, or a run or step "
            "directory)"
        )
    draft = getattr(model, draft_key, model)
    expected = {**dict(draft.named_parameters()),
                **dict(draft.named_buffers())}
    sft = os.path.join(checkpoint_path, "model.safetensors")
    if os.path.exists(sft):
        tensors, _ = load_feature_file(sft)
        loaded = draft_state_from_export(tensors, expected)
    else:
        loaded = _checkpoint_draft_state(checkpoint_path, expected, draft_key)
    for name, value in loaded.items():
        expected[name].copy_(value)
    return len(loaded)
