"""Expected-acceptance (LK) objectives for speculative decoding.

``expected acceptance = sum_v min(p_target_v, p_draft_v)`` per token; the LK
loss modes blend it with the KL (CE) loss. Counterpart of
``specforge_tpu/ops/lk_loss.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

ACCEPTANCE_CHUNK = 8192


def _acceptance_per_token(
    logits: torch.Tensor,
    target_probs: torch.Tensor,
    ratio: Optional[torch.Tensor] = None,
    chunk: int = ACCEPTANCE_CHUNK,
) -> torch.Tensor:
    """sum_v min(softmax(logits)_v, q_v) per token, streamed over vocab chunks
    so no [B, S, V] fp32 temporary persists.

    ``ratio`` [B, S, 1]: optional factored teacher scale — the effective
    teacher is ``target_probs * ratio``, multiplied chunk by chunk.
    """
    v = logits.shape[-1]
    ratio32 = None if ratio is None else ratio.float()
    if v <= chunk:
        draft_p = torch.softmax(logits.float(), dim=-1)
        q = target_probs.float()
        if ratio32 is not None:
            q = q * ratio32
        return torch.minimum(q, draft_p).sum(dim=-1)

    lse = torch.logsumexp(logits.float(), dim=-1, keepdim=True)
    total = torch.zeros(logits.shape[:-1], dtype=torch.float32,
                        device=logits.device)
    for lo in range(0, v, chunk):
        draft_p = torch.exp(logits[..., lo:lo + chunk].float() - lse)
        q32 = target_probs[..., lo:lo + chunk].float()
        if ratio32 is not None:
            q32 = q32 * ratio32
        total = total + torch.minimum(draft_p, q32).sum(dim=-1)
    return total


def acceptance_sums(
    logits: torch.Tensor,
    target_probs: torch.Tensor,
    position_mask: torch.Tensor,
    ratio: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The masked sums of the acceptance and the log-acceptance per token,
    and the mask's sum: the numerators and the denominator of
    :func:`compute_acceptance_rate`, for a caller that sums them over the
    ranks of a mesh first."""
    acc_per_token = _acceptance_per_token(logits, target_probs, ratio)
    log_acc_per_token = torch.where(
        acc_per_token > 0, torch.log(acc_per_token),
        torch.zeros_like(acc_per_token))
    mask = position_mask.squeeze(-1).to(acc_per_token.dtype)
    return (torch.sum(acc_per_token * mask),
            torch.sum(log_acc_per_token * mask), torch.sum(mask))


def compute_acceptance_rate(
    logits: torch.Tensor,
    target_probs: torch.Tensor,
    position_mask: torch.Tensor,
    eps: float = 1e-8,
    ratio: Optional[torch.Tensor] = None,
    reduce: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked-mean acceptance and log-acceptance over valid positions.

    The un-renormalized teacher restricted to the draft vocab is
    ``target_probs`` (optionally factored as ``target_probs * ratio``); draft
    probabilities come from a full softmax of the draft logits in fp32.
    ``reduce`` sums numerators and denominators over the ranks of a mesh
    (the ``reduce_axes`` psum of the JAX version).
    """
    acc_num, log_num, den = acceptance_sums(logits, target_probs,
                                            position_mask, ratio)
    if reduce is not None:
        acc_num, log_num, den = reduce(acc_num), reduce(log_num), reduce(den)
    den = torch.clamp(den, min=eps)
    return acc_num / den, log_num / den


def compute_lk_loss(
    kl_loss: torch.Tensor,
    acceptance_rate: torch.Tensor,
    log_acceptance_rate: torch.Tensor,
    lk_loss_type: str,
    kl_scale: float,
    kl_decay: float,
) -> torch.Tensor:
    """LK objective: ``alpha`` = -E[log a]; ``lambda`` = adaptive KL/(1-a) blend."""
    if lk_loss_type == "alpha":
        return -log_acceptance_rate
    if lk_loss_type == "lambda":
        kl_weight = kl_scale * torch.exp(-kl_decay * acceptance_rate.detach())
        return kl_weight * kl_loss + (1 - kl_weight) * (1 - acceptance_rate)
    raise ValueError(f"Unknown lk loss type: {lk_loss_type}")
