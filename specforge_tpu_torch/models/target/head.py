"""Frozen target lm_head: projects stored last hidden states to teacher logits.

Counterpart of ``specforge_tpu/models/target/head.py``: offline capture
stores the target's final hidden state; the trainer re-runs the frozen head
and owns the teacher shift. :meth:`TargetHead.from_pretrained` reads the
head (or the embedding) from a local HF checkpoint directory through its
safetensors index, with the port's own safetensors reader.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Tuple

import torch

from specforge_tpu_torch.runtime.data_plane.feature_file import (
    read_safetensors_keys,
    read_safetensors_tensor,
)
from specforge_tpu_torch.utils import shift_pad


class TargetHead:
    """Holds the [V, H] lm_head weight (bf16 by default) on the CPU."""

    def __init__(self, weight: torch.Tensor):
        self.weight = weight

    @classmethod
    def from_pretrained(
        cls,
        model_path: str,
        lm_head_key: str = "lm_head.weight",
        dtype: torch.dtype = torch.bfloat16,
    ) -> "TargetHead":
        """Load ``lm_head_key`` from a local HF checkpoint dir via its
        ``*.index.json`` weight map, or from a single ``model.safetensors``.
        A tied-embedding target omits ``lm_head.weight``; the loader then
        reads ``model.embed_tokens.weight`` when the config declares
        ``tie_word_embeddings``."""
        raw: dict = {}
        config_path = os.path.join(model_path, "config.json")
        if os.path.exists(config_path):
            with open(config_path) as f:
                raw = json.load(f)
        tied_fallback = (
            lm_head_key == "lm_head.weight"
            and raw.get("tie_word_embeddings", False)
        )
        index_files = glob.glob(os.path.join(model_path, "*.index.json"))
        if len(index_files) > 1:
            raise FileNotFoundError(
                f"Multiple index.json files found in {model_path}"
            )
        if index_files:
            with open(index_files[0]) as f:
                weight_map = json.load(f)["weight_map"]
            if lm_head_key not in weight_map and tied_fallback:
                lm_head_key = "model.embed_tokens.weight"
            shard_path = os.path.join(model_path, weight_map[lm_head_key])
        else:
            shard_path = os.path.join(model_path, "model.safetensors")
            if not os.path.exists(shard_path):
                raise FileNotFoundError(
                    f"No index.json or model.safetensors in {model_path}"
                )
        if (lm_head_key not in read_safetensors_keys(shard_path)
                and tied_fallback):
            lm_head_key = "model.embed_tokens.weight"
        weight = read_safetensors_tensor(shard_path, lm_head_key).to(dtype)
        is_head = lm_head_key == "lm_head.weight" or tied_fallback
        mup = raw.get("logits_mup_width_multiplier") or (
            raw.get("text_config") or {}
        ).get("logits_mup_width_multiplier")
        if is_head and mup:
            raise NotImplementedError(
                "muP targets (logits_mup_width_multiplier) are not ported "
                "yet; see ROADMAP.md, Queue 1"
            )
        return cls(weight)


def target_head_preprocess(
    input_ids: torch.Tensor, target: torch.Tensor, loss_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The teacher shift for offline hidden-state captures.

    Shifts ``target`` (hidden or logits) and ``input_ids`` one step left
    (position s now holds the teacher signal for predicting token s+1) and
    expands ``loss_mask`` to [B, S, 1].
    """
    target = shift_pad(target, left=False)
    input_ids = shift_pad(input_ids, left=False)
    if loss_mask.dim() == 2:
        loss_mask = loss_mask[..., None]
    return input_ids, target, loss_mask


def apply_target_head(weight: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    """[B, S, H] hidden × [V, H] head → [B, S, V] logits in the weight's dtype."""
    return torch.matmul(hidden.to(weight.dtype), weight.T)
