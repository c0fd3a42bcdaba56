"""Fused draft-vocab cross-entropy against a dense teacher distribution.

``loss = -mean_over_rows( position_mask * sum_v target_p * log_softmax(logits) )``

where the mean is over **all** B*T rows (masked rows contribute 0 but still
count in the denominator). Counterpart of ``specforge_tpu/ops/loss.py``:

- :func:`log_softmax_loss_reference` — plain PyTorch, the parity oracle.
- :func:`log_softmax_loss` — the forward dispatch: the fused CE kernel of
  :mod:`specforge_tpu_torch.ops.loss_cuda` on CUDA tensors, its plain version
  on CPU tensors.
"""

from __future__ import annotations

import torch

from specforge_tpu_torch.ops.loss_cuda import loss_forward


def log_softmax_loss_reference(
    logits: torch.Tensor, target_p: torch.Tensor, position_mask: torch.Tensor
) -> torch.Tensor:
    """[B, T, V] logits × [B, T, V] teacher × [B, T, 1] mask → scalar f32 loss."""
    out_logp = torch.log_softmax(logits.float(), dim=2)
    plogp = target_p.float() * out_logp
    return -torch.sum(position_mask.float() * plogp, dim=2).mean()


def log_softmax_loss(
    logits: torch.Tensor, target_p: torch.Tensor, position_mask: torch.Tensor
) -> torch.Tensor:
    """Fused CE loss (forward). The teacher slice is made contiguous here,
    since the kernel reads whole rows."""
    loss, _ = loss_forward(
        logits.contiguous(), target_p.contiguous(), position_mask
    )
    return loss
