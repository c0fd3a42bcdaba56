"""Batch collation with static shapes.

Counterpart of ``PaddingCollator`` in ``specforge_tpu/data/collator.py``:
every sample is padded (or truncated) to a fixed ``max_length``. Feature
conventions (EAGLE3 offline layout): ``input_ids`` [S], ``loss_mask`` [S] or
[S, 1], ``hidden_state`` [S, 3H] aux concat, ``target`` [S, H] last hidden.
``attention_mask`` is derived from the true length when absent.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from specforge_tpu_torch.runtime.contracts import TrainBatch


@dataclass(frozen=True)
class CollatorConfig:
    max_length: int
    pad_token_id: int = 0
    #: cast floating features to this dtype name on the host (None = keep)
    cast_float_dtype: Optional[str] = None


def _pad_to(x: torch.Tensor, length: int, pad_value=0) -> torch.Tensor:
    s = x.shape[0]
    if s >= length:
        return x[:length]
    pad = [0, 0] * (x.dim() - 1) + [0, length - s]
    return F.pad(x, pad, value=pad_value)


class PaddingCollator:
    """List of per-sample tensor dicts → TrainBatch of [B, max_length, ...]."""

    def __init__(self, config: CollatorConfig):
        self.config = config

    def __call__(
        self,
        samples: Sequence[Mapping[str, torch.Tensor]],
        sample_ids: Optional[Sequence[str]] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> TrainBatch:
        L = self.config.max_length
        batch: Dict[str, List[torch.Tensor]] = {}
        lengths = []
        for sample in samples:
            lengths.append(min(sample["input_ids"].numel(), L))
            for name, value in sample.items():
                x = torch.as_tensor(value)
                if name == "input_ids":
                    x = _pad_to(x.reshape(-1).to(torch.int32), L,
                                self.config.pad_token_id)
                elif name == "loss_mask":
                    x = _pad_to(x.reshape(x.shape[0], -1)[:, 0].to(torch.int32),
                                L)
                elif name == "attention_mask":
                    x = _pad_to(x.reshape(-1).to(torch.int32), L)
                elif name == "position_ids":
                    if x.dim() != 1:
                        raise ValueError(
                            "only [S] position_ids are supported by the port "
                            f"(mrope comes later), got {tuple(x.shape)}"
                        )
                    x = _pad_to(x.to(torch.int32), L)
                elif x.dim() == 1:
                    x = _pad_to(x, L)
                else:
                    x = _pad_to(x.reshape(x.shape[0], -1), L)
                batch.setdefault(name, []).append(x)
        if "attention_mask" not in batch:
            masks = []
            for n in lengths:
                m = torch.zeros(L, dtype=torch.int32)
                m[:n] = 1
                masks.append(m)
            batch["attention_mask"] = masks

        cast = self.config.cast_float_dtype
        stacked = {}
        for name, xs in batch.items():
            out = torch.stack(xs)
            if cast and out.is_floating_point():
                out = out.to(getattr(torch, cast))
            stacked[name] = out
        if "loss_mask" in stacked and stacked["loss_mask"].dim() == 2:
            stacked["loss_mask"] = stacked["loss_mask"][..., None]
        return TrainBatch(
            tensors=stacked,
            sample_ids=list(sample_ids or []),
            metadata=dict(metadata or {}),
        )
