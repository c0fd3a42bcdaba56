"""EAGLE3 training strategy: TrainBatch tensors → loss + metrics.

Counterpart of ``specforge_tpu/training/strategies.py`` (``StepOutput`` and
``Eagle3TrainStrategy``). The JAX strategy receives its parameters
explicitly; here the strategy holds the :class:`OnlineEagle3Model`, whose
parameters live on its device, and moves each batch there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch

from specforge_tpu_torch.models.target.head import (
    apply_target_head,
    target_head_preprocess,
)
from specforge_tpu_torch.utils import model_device, to_device


@dataclass
class StepOutput:
    """loss keeps grad; metrics are detached scalars; ratio_metrics are
    (numerator, denominator) pairs summed across batches before dividing."""

    loss: torch.Tensor
    metrics: Dict[str, torch.Tensor] = field(default_factory=dict)
    ratio_metrics: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict
    )


@dataclass(frozen=True)
class StepContext:
    global_step: Any = 0
    total_steps: Optional[int] = None


class Eagle3TrainStrategy:
    """EAGLE3 TTT strategy over :class:`OnlineEagle3Model`.

    ``target_repr``:
      - "hidden_state" (offline): re-run the frozen head over the stored last
        hidden state — or stream it in vocab chunks when ``compact_teacher``.
      - "logits"/None (online): use delivered teacher logits as they are.
    """

    name = "eagle3"
    required_features = {
        "input_ids", "attention_mask", "loss_mask", "hidden_state", "target",
    }

    def __init__(
        self,
        model,
        *,
        ploss_decay: float = 0.8,
        compact_teacher: bool = False,
        compact_teacher_chunk_size: int = 32768,
    ) -> None:
        self.model = model
        self.ploss_decay = ploss_decay
        self.compact_teacher = compact_teacher
        self.compact_teacher_chunk_size = compact_teacher_chunk_size

    def validate_batch(self, tensors: Dict[str, Any]) -> None:
        missing = {f for f in self.required_features if f not in tensors}
        if missing:
            raise ValueError(
                f"{self.name} batch missing required features {sorted(missing)}; "
                f"present={sorted(tensors)}"
            )

    def _inputs(self, tensors, frozen, metadata, compact: bool):
        """Device placement, the teacher shift and the model's arguments."""
        self.validate_batch(tensors)
        device = model_device(self.model)
        tensors = to_device(tensors, device)
        frozen = to_device(frozen, device)
        input_ids = tensors["input_ids"]
        target = tensors["target"]
        loss_mask = tensors["loss_mask"]
        kwargs: Dict[str, Any] = {}
        if (metadata or {}).get("target_repr") == "hidden_state":
            head_w = frozen.get("target_head_weight")
            if head_w is None:
                raise ValueError(
                    "target_repr='hidden_state' requires "
                    "frozen['target_head_weight']"
                )
            input_ids, target_hidden, loss_mask = target_head_preprocess(
                input_ids, target, loss_mask
            )
            if compact:
                target = None
                kwargs.update(
                    target_hidden_for_compact=target_hidden,
                    target_head_weight=head_w,
                    compact_teacher_chunk_size=self.compact_teacher_chunk_size,
                )
            else:
                target = apply_target_head(head_w, target_hidden)
        elif loss_mask.dim() == 2:
            loss_mask = loss_mask[..., None]
        return (
            input_ids, tensors["attention_mask"], loss_mask,
            tensors["hidden_state"], target,
        ), dict(position_ids=tensors.get("position_ids"), **kwargs)

    def forward_loss(
        self,
        tensors: Dict[str, torch.Tensor],
        frozen: Dict[str, torch.Tensor],
        ctx: Optional[StepContext] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> StepOutput:
        args, kwargs = self._inputs(tensors, frozen, metadata,
                                    self.compact_teacher)
        out = self.model(*args, **kwargs)
        length = out.plosses.shape[0]
        weights = torch.tensor(
            [self.ploss_decay ** i for i in range(length)],
            dtype=torch.float32, device=out.plosses.device,
        )
        loss = torch.sum(weights * out.plosses)
        ratio_metrics = {}
        for i in range(length):
            ratio_metrics[f"acc_{i}"] = (
                out.metric_corrects[i], out.metric_denoms[i]
            )
            ratio_metrics[f"ploss_{i}"] = (
                out.metric_losses[i] * out.metric_loss_denoms[i],
                out.metric_loss_denoms[i],
            )
        metrics = {
            f"acceptance_rate_{i}": out.acceptance_rates[i] for i in range(length)
        }
        return StepOutput(loss=loss, metrics=metrics, ratio_metrics=ratio_metrics)

    def eval_outputs(
        self,
        tensors: Dict[str, torch.Tensor],
        frozen: Dict[str, torch.Tensor],
        metadata: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Batch-size-invariant eval sums: per-TTT-position numerators and
        denominators, divided only after reduction over the eval set. The
        eval pass uses the full-vocab head, as the JAX strategy does."""
        args, kwargs = self._inputs(tensors, frozen, metadata, compact=False)
        out = self.model(*args, **kwargs)
        return {
            "corrects": out.metric_corrects,
            "denoms": out.metric_denoms,
            "acc_nums": out.acceptance_nums,
            "acc_dens": out.acceptance_denoms,
            "loss_sums": out.metric_losses * out.metric_loss_denoms,
            "loss_dens": out.metric_loss_denoms,
        }
