"""Fused draft-vocab cross-entropy against a dense teacher distribution.

``loss = -mean_over_rows( position_mask * sum_v target_p * log_softmax(logits) )``

where the mean is over **all** B*T rows (masked rows contribute 0 but still
count in the denominator). Counterpart of ``specforge_tpu/ops/loss.py``:

- :func:`log_softmax_loss_reference` — plain PyTorch, the parity oracle.
- :func:`log_softmax_loss` — the fused CE as a ``torch.autograd.Function``,
  differentiable in ``logits`` only (the teacher is detached): the forward
  and backward kernels of :mod:`specforge_tpu_torch.ops.loss_cuda` on CUDA
  tensors, their plain versions on CPU tensors. It saves the row statistics
  (m, d, ts, mask) of the forward, as the JAX ``_loss_vjp_fwd`` does.
"""

from __future__ import annotations

import torch

from specforge_tpu_torch.ops.loss_cuda import loss_backward, loss_forward


def log_softmax_loss_reference(
    logits: torch.Tensor, target_p: torch.Tensor, position_mask: torch.Tensor
) -> torch.Tensor:
    """[B, T, V] logits × [B, T, V] teacher × [B, T, 1] mask → scalar f32 loss."""
    out_logp = torch.log_softmax(logits.float(), dim=2)
    plogp = target_p.float() * out_logp
    return -torch.sum(position_mask.float() * plogp, dim=2).mean()


class _FusedLogSoftmaxLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target_p, position_mask):
        loss, stats = loss_forward(logits, target_p, position_mask)
        ctx.save_for_backward(logits, target_p, *stats)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, target_p, *stats = ctx.saved_tensors
        return loss_backward(logits, target_p, tuple(stats), g), None, None


def log_softmax_loss(
    logits: torch.Tensor, target_p: torch.Tensor, position_mask: torch.Tensor
) -> torch.Tensor:
    """Fused CE loss. The teacher is taken as it is (a window of the padded
    teacher is read through its batch stride, not copied)."""
    return _FusedLogSoftmaxLoss.apply(logits.contiguous(), target_p.detach(),
                                      position_mask)
