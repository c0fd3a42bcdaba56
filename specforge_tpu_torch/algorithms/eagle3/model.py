"""EAGLE3 test-time-training (TTT) wrapper.

Counterpart of ``specforge_tpu/algorithms/eagle3/model.py``. The TTT loop is
a Python loop of ``length`` steps: per step the draft predicts one token
further ahead, and its K/V join the branch cache so later steps attend to
them diagonally.

1. Teacher projection to the draft vocab (full-vocab logits, or the compact
   path from the last hidden state and the head weight), padded by
   ``length`` along the sequence.
2. ``fc`` projection of the 3-layer aux hidden concat.
3. Per step: slice the teacher by the step index → embed ids → decoder step
   with branch-cache attention (RoPE offset = branch index) → draft logits →
   fused CE and acceptance metrics → shift ids/masks one position left.

Every teacher tensor is detached. Outputs are stacked per-step tensors so the
strategy can weight the losses and the evaluator can reduce metrics as
numerator/denominator pairs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from specforge_tpu_torch.models.draft.llama_eagle3 import LlamaEagle3Draft
from specforge_tpu_torch.ops.attention import make_causal_bias
from specforge_tpu_torch.ops.lk_loss import compute_acceptance_rate, compute_lk_loss
from specforge_tpu_torch.ops.loss import (
    log_softmax_loss,
    log_softmax_loss_reference,
)
from specforge_tpu_torch.ops.teacher import (
    compute_target_p_padded,
    compute_target_p_padded_from_hidden,
)
from specforge_tpu_torch.utils import shift_pad

#: "fused" = the fused CE (kernel on CUDA, its plain version on CPU);
#: "reference" = the plain log-softmax oracle on any device
LOSS_BACKENDS = ("fused", "reference")


class TTTOutputs(NamedTuple):
    """Per-TTT-step tensors, each of shape [length].

    ``acceptance_nums``/``acceptance_denoms`` carry the masked acceptance sum
    and mask count separately so the evaluator can reduce across batches
    before dividing."""

    plosses: torch.Tensor
    acceptance_rates: torch.Tensor
    acces: torch.Tensor
    metric_corrects: torch.Tensor
    metric_denoms: torch.Tensor
    metric_losses: torch.Tensor
    metric_loss_denoms: torch.Tensor
    acceptance_nums: torch.Tensor
    acceptance_denoms: torch.Tensor


class OnlineEagle3Model(nn.Module):
    """TTT training model over a draft submodule (named ``draft_model`` so the
    parameter names match the JAX tree and the reference checkpoint)."""

    def __init__(
        self,
        draft_model: LlamaEagle3Draft,
        length: int = 7,
        lk_loss_type: Optional[str] = None,
        kl_scale: float = 1.0,
        kl_decay: float = 1.0,
        loss_backend: str = "fused",
    ):
        super().__init__()
        if loss_backend not in LOSS_BACKENDS:
            raise ValueError(f"loss_backend {loss_backend!r} not in {LOSS_BACKENDS}")
        self.draft_model = draft_model
        self.length = length
        self.lk_loss_type = lk_loss_type
        self.kl_scale = kl_scale
        self.kl_decay = kl_decay
        self.loss_fn = (
            log_softmax_loss if loss_backend == "fused"
            else log_softmax_loss_reference
        )

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        loss_mask: torch.Tensor,
        hidden_states: torch.Tensor,
        target: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        target_hidden_for_compact: Optional[torch.Tensor] = None,
        target_head_weight: Optional[torch.Tensor] = None,
        compact_teacher_chunk_size: int = 32768,
    ) -> TTTOutputs:
        """input_ids [B, S] (already teacher-shifted), attention_mask [B, S],
        loss_mask [B, S, 1], hidden_states [B, S, 3*target_hidden], target
        [B, S, V] full-vocab teacher logits (or None when the compact path
        supplies hidden + head weight)."""
        draft = self.draft_model
        t2d, d2t = draft.t2d, draft.d2t

        with torch.no_grad():
            if target_hidden_for_compact is not None:
                teacher = compute_target_p_padded_from_hidden(
                    target_hidden_for_compact, target_head_weight, t2d, d2t,
                    loss_mask, self.length,
                    chunk_size=compact_teacher_chunk_size,
                )
            else:
                teacher = compute_target_p_padded(
                    target, t2d, d2t, loss_mask, self.length
                )
        target_p_padded, accept_ratio_padded, token_ids_padded, position_mask = (
            teacher
        )

        batch_size, seq_len = input_ids.shape
        hidden = draft.project_hidden_states(hidden_states)
        if draft.attention_backend == "pallas":
            # the kernel never materializes the [S, S] bias; padding rides
            # the [B, S] key-validity mask
            bias, key_valid = None, attention_mask
        else:
            bias = make_causal_bias(attention_mask, batch_size, seq_len)
            key_valid = None
        if position_ids is None:
            position_ids = torch.arange(
                seq_len, device=input_ids.device
            ).expand(batch_size, seq_len)

        cache = ((), ())
        cur_input_ids = input_ids
        cur_loss_mask = loss_mask
        cur_position_mask = position_mask
        steps = []
        for idx in range(self.length):
            step_target_p = target_p_padded[:, idx:idx + seq_len]
            step_ratio = accept_ratio_padded[:, idx:idx + seq_len]
            step_token_ids = token_ids_padded[:, idx:idx + seq_len]

            embeds = draft.embed_input_ids(cur_input_ids).to(hidden.dtype)
            hidden, cache = draft.ttt_step(
                embeds, hidden, cache, bias, position_ids, key_valid
            )
            logits = draft.compute_logits(hidden)

            # token accuracy against the teacher argmax
            pred_draft = torch.argmax(logits, dim=-1)
            pred_target = pred_draft + d2t[pred_draft]
            lm = cur_loss_mask[..., 0].float()
            correct = torch.sum((pred_target == step_token_ids).float() * lm)
            denom = torch.clamp(torch.sum(lm), min=1e-6)

            kl_loss = self.loss_fn(logits, step_target_p, cur_position_mask)
            # without an LK loss the acceptance rate is a metric only: it
            # reads detached logits, so autograd keeps none of its fp32
            # softmax intermediates (the JAX model's stop_gradient lets XLA
            # drop its backward the same way)
            acceptance_rate, log_acceptance_rate = compute_acceptance_rate(
                logits if self.lk_loss_type is not None else logits.detach(),
                step_target_p, cur_position_mask, ratio=step_ratio
            )
            if self.lk_loss_type is None:
                loss = kl_loss
            else:
                loss = compute_lk_loss(
                    kl_loss, acceptance_rate, log_acceptance_rate,
                    self.lk_loss_type, self.kl_scale, self.kl_decay,
                )
            pos_den = torch.sum(cur_position_mask.float())
            steps.append((
                loss,
                acceptance_rate.detach(),
                correct / denom,
                correct,
                denom,
                loss.detach(),
                torch.tensor(float(logits.shape[0] * logits.shape[1]),
                             device=logits.device),
                acceptance_rate.detach() * pos_den,
                pos_den,
            ))
            if idx != self.length - 1:
                cur_input_ids = shift_pad(cur_input_ids, left=False)
                cur_position_mask = shift_pad(cur_position_mask, left=False)
                cur_loss_mask = shift_pad(cur_loss_mask, left=False)

        return TTTOutputs(*(torch.stack(col) for col in zip(*steps)))
