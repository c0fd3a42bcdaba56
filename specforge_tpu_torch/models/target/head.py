"""Frozen target lm_head: projects stored last hidden states to teacher logits.

Counterpart of ``specforge_tpu/models/target/head.py`` (the functional part):
offline capture stores the target's final hidden state; the trainer re-runs
the frozen head and owns the teacher shift.
"""

from __future__ import annotations

from typing import Tuple

import torch

from specforge_tpu_torch.utils import shift_pad


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
