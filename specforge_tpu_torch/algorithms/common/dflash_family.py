"""DFlash-family training wrappers (DFlash and Domino).

Counterpart of ``OnlineDFlashModel`` and ``OnlineDominoModel`` in
``specforge_tpu/algorithms/common/dflash_family.py``: anchors from doubly
supervised positions, mask-token query blocks, same-position labels (block
position k → token anchor+k, or anchor+1+k under Domino's ``shift_label``),
the frozen target ``lm_head``/``embed_tokens`` passed in as tensors, and the
per-family losses:

- DFlash: masked CE (optional exponential position decay, optional D-PACE
  confidence weights) with the ``loss_terms`` (numerator, denominator)
  contract for normalising the gradient over the accumulation window;
- Domino: GRU-corrected final CE blended with the base CE by a decaying
  ``lambda_base``; per-block accept-length telemetry.

``forward`` samples the anchors from ``generator`` (a ``torch.Generator``)
unless ``anchors=(positions, keep)`` is given; the parity tests hand in the
anchors the JAX sampler drew. The vocab objective is the fused one
(:mod:`specforge_tpu_torch.ops.fused_objective`) by default, or the
checkpointed chunk reduction when ``fused_objective`` is False.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from specforge_tpu_torch.ops.chunking import checkpointed_chunk_reduce
from specforge_tpu_torch.ops.fused_objective import (
    compute_accept_len,
    dflash_objective_fused,
    domino_objective_fused,
    dpace_weight,
    linear_rows,
    masked_cross_entropy,
)
from specforge_tpu_torch.ops.masks import sample_anchor_positions

VALID_LOSS_TYPES = (
    "dflash",
    "dpace",
    "dpace-cumulative-confidence-only",
    "dpace-continuation-value-only",
)

Anchors = Tuple[torch.Tensor, torch.Tensor]


class OnlineDFlashModel(nn.Module):
    def __init__(
        self,
        draft_model,
        mask_token_id: int,
        block_size: int = 16,
        num_anchors: int = 512,
        loss_decay_gamma: Optional[float] = None,
        objective_chunk_blocks: int = 128,
        loss_type: str = "dflash",
        dpace_alpha: float = 0.5,
        fused_objective: bool = True,
    ):
        super().__init__()
        if loss_type not in VALID_LOSS_TYPES:
            raise ValueError(
                f"loss_type={loss_type!r}; one of {list(VALID_LOSS_TYPES)}")
        if not 0.0 <= dpace_alpha <= 1.0:
            raise ValueError(f"dpace_alpha must be in [0,1], got {dpace_alpha}")
        self.draft_model = draft_model
        self.mask_token_id = int(mask_token_id)
        self.block_size = int(block_size)
        self.num_anchors = int(num_anchors)
        self.loss_decay_gamma = loss_decay_gamma
        self.objective_chunk_blocks = int(objective_chunk_blocks)
        self.loss_type = loss_type
        self.dpace_alpha = float(dpace_alpha)
        self.fused_objective = fused_objective

    # --- shared block machinery -------------------------------------------
    def _anchors(self, loss_mask, generator, anchors) -> Anchors:
        if anchors is not None:
            positions, keep = anchors
            return (positions.to(loss_mask.device, torch.int32),
                    keep.to(loss_mask.device, torch.bool))
        if generator is None:
            raise ValueError("pass a generator or anchors=(positions, keep)")
        return sample_anchor_positions(generator, loss_mask, self.num_anchors)

    def _forward_draft_blocks(self, input_ids, hidden_states, loss_mask,
                              embed_weight, generator, anchors):
        b, seq_len = input_ids.shape
        anchor_positions, keep = self._anchors(loss_mask, generator, anchors)
        n = anchor_positions.shape[1]
        bs = self.block_size
        anchor_tokens = input_ids.gather(
            1, anchor_positions.long().clamp(0, seq_len - 1))
        first = torch.where(keep, anchor_tokens,
                            torch.full_like(anchor_tokens, self.mask_token_id))
        noise_ids = torch.full((b, n, bs), self.mask_token_id,
                               dtype=torch.long, device=input_ids.device)
        noise_ids[:, :, 0] = first
        noise_embedding = F.embedding(noise_ids.view(b, n * bs), embed_weight)
        offsets = torch.arange(bs, device=input_ids.device)
        ctx_pos = torch.arange(seq_len, device=input_ids.device).expand(
            b, seq_len)
        draft_pos = (anchor_positions.long()[..., None] + offsets).view(b, -1)
        output_hidden = self.draft_model(
            noise_embedding, hidden_states, ctx_pos, draft_pos,
            anchor_positions, keep,
        )
        return anchor_positions, keep, output_hidden

    def _gather_labels(self, input_ids, anchor_positions, start_offset=0):
        """target ids [B, N, block] at anchor + start_offset + k, their
        in-range mask and the clamped indices."""
        b, seq_len = input_ids.shape
        offsets = torch.arange(start_offset, start_offset + self.block_size,
                               device=input_ids.device)
        label_indices = anchor_positions.long()[..., None] + offsets
        valid = label_indices < seq_len
        safe = label_indices.clamp(0, seq_len - 1)
        target_ids = input_ids.long().gather(1, safe.view(b, -1)).view(
            safe.shape)
        return target_ids, valid, safe

    @staticmethod
    def _gather_loss_mask(loss_mask, safe):
        b = safe.shape[0]
        return loss_mask.float().gather(1, safe.view(b, -1)).view(safe.shape)

    def _decay(self, offset: int, device) -> Optional[torch.Tensor]:
        if not (self.loss_decay_gamma and self.loss_decay_gamma > 0):
            return None
        k = torch.arange(self.block_size, dtype=torch.float32, device=device)
        return torch.exp(-torch.clamp(k - offset, min=0)
                         / self.loss_decay_gamma)

    def _objective_chunk_terms(self, lm_head_weight):
        def fn(hidden, target_ids, weight_mask):
            logits = linear_rows(hidden, lm_head_weight.to(hidden.dtype))
            neg_log_q = masked_cross_entropy(logits, target_ids)
            if self.loss_type == "dflash":
                loss_weights = weight_mask
                decay = self._decay(1, hidden.device)
                if decay is not None:
                    loss_weights = loss_weights * decay
                loss_num = torch.sum(neg_log_q * loss_weights)
                loss_den = torch.sum(loss_weights)
            else:
                prob = torch.exp(-neg_log_q).detach()
                dpace_w = dpace_weight(prob, weight_mask, weight_mask > 0,
                                       self.loss_type, self.dpace_alpha)
                loss_num = torch.sum(neg_log_q * weight_mask * dpace_w)
                loss_den = torch.zeros((), device=hidden.device)
            predicted = logits.argmax(dim=-1)
            correct_num = ((predicted == target_ids) & (weight_mask > 0.5)
                           ).float().sum()
            return loss_num, loss_den, correct_num, weight_mask.sum()

        return fn

    def forward(
        self,
        input_ids: torch.Tensor,       # [B, S]
        hidden_states: torch.Tensor,   # [B, S, L*h] capture concat
        loss_mask: torch.Tensor,       # [B, S] or [B, S, 1]
        lm_head_weight: torch.Tensor,  # frozen [V, h]
        embed_weight: torch.Tensor,    # frozen [V, h]
        generator: Optional[torch.Generator] = None,
        *,
        anchors: Optional[Anchors] = None,
    ):
        b = input_ids.shape[0]
        if loss_mask.dim() == 3:
            loss_mask = loss_mask[..., 0]
        anchor_positions, keep, output_hidden = self._forward_draft_blocks(
            input_ids, hidden_states, loss_mask, embed_weight, generator,
            anchors)
        target_ids, valid, safe = self._gather_labels(input_ids,
                                                      anchor_positions)
        pos_in_block = torch.arange(self.block_size, device=input_ids.device)
        weight_mask = (keep[..., None].float() * valid.float()
                       * (pos_in_block > 0).float()
                       * self._gather_loss_mask(loss_mask, safe))
        n = anchor_positions.shape[1]
        hidden_4d = output_hidden.view(b, n, self.block_size, -1)
        if self.fused_objective:
            loss_weights = weight_mask
            decay = self._decay(1, input_ids.device)
            if self.loss_type == "dflash" and decay is not None:
                loss_weights = weight_mask * decay
            loss_num, loss_den, correct_num, accuracy_den = (
                dflash_objective_fused(
                    hidden_4d, target_ids, loss_weights, weight_mask,
                    lm_head_weight, self.loss_type, self.dpace_alpha,
                    self.objective_chunk_blocks))
        else:
            loss_num, loss_den, correct_num, accuracy_den = (
                checkpointed_chunk_reduce(
                    self._objective_chunk_terms(lm_head_weight), hidden_4d,
                    target_ids, weight_mask,
                    chunk_size=self.objective_chunk_blocks, axis=1))
        loss_denominator = (
            loss_den if self.loss_type == "dflash"
            else torch.tensor(float(b), device=loss_num.device))
        loss = loss_num / torch.clamp(loss_denominator, min=1e-6)
        accuracy = correct_num / torch.clamp(accuracy_den, min=1e-6)
        metrics = {
            "accuracy_denom": accuracy_den,
            "ratio_metrics": {"acc": (correct_num, accuracy_den)},
            "loss_terms": (loss_num, loss_denominator.detach()),
        }
        return loss, accuracy, metrics


class OnlineDominoModel(OnlineDFlashModel):
    """Domino: DFlash blocks + GRU-corrected logits, decaying base blend."""

    def __init__(self, draft_model, mask_token_id: int,
                 shift_label: bool = False, **kwargs):
        super().__init__(draft_model, mask_token_id, **kwargs)
        self.shift_label = bool(shift_label)

    def forward(
        self,
        input_ids,
        hidden_states,
        loss_mask,
        lm_head_weight,
        embed_weight,
        generator: Optional[torch.Generator] = None,
        lambda_base: float = 0.0,
        *,
        anchors: Optional[Anchors] = None,
    ):
        b, seq_len = input_ids.shape
        if loss_mask.dim() == 3:
            loss_mask = loss_mask[..., 0]
        anchor_positions, keep, output_hidden = self._forward_draft_blocks(
            input_ids, hidden_states, loss_mask, embed_weight, generator,
            anchors)
        target_ids, valid, safe = self._gather_labels(
            input_ids, anchor_positions, 1 if self.shift_label else 0)
        n = anchor_positions.shape[1]
        hidden4d = output_hidden.view(b, n, self.block_size, -1)
        if self.shift_label:
            prev_idx = (anchor_positions.long()[..., None] + torch.arange(
                self.block_size, device=input_ids.device)).clamp(
                    0, seq_len - 1)
            prev_ids = input_ids.long().gather(1, prev_idx.view(b, -1)).view(
                prev_idx.shape)
        else:
            prev_ids = target_ids
        weight_mask = keep[..., None].float() * valid.float()
        if not self.shift_label:
            pos_in_block = torch.arange(self.block_size,
                                        device=input_ids.device)
            weight_mask = weight_mask * (pos_in_block > 0).float()
        weight_mask = weight_mask * self._gather_loss_mask(loss_mask, safe)
        eval_weight_mask = weight_mask
        decay = self._decay(0 if self.shift_label else 1, input_ids.device)
        if decay is not None:
            weight_mask = weight_mask * decay

        draft = self.draft_model
        if self.fused_objective:
            prev_emb = F.embedding(prev_ids, embed_weight)
            corr_act = draft.correction_activation(prev_emb, hidden4d)
            (blend_num, final_num, base_num, loss_den, correct_num,
             base_correct, accuracy_den, accept_num, base_accept_num,
             accept_den) = domino_objective_fused(
                hidden4d, corr_act, draft.logits_head_kernel(), target_ids,
                weight_mask, eval_weight_mask, lambda_base, lm_head_weight,
                self.objective_chunk_blocks)
            valid_token_count = loss_den + 1e-6
            return self._domino_outputs(
                blend_num / valid_token_count, final_num / valid_token_count,
                base_num / valid_token_count, correct_num, base_correct,
                accuracy_den, accept_num, base_accept_num, accept_den,
                lambda_base)

        def chunk_fn(hidden, prev_ids_c, target_ids_c, w_mask, ew_mask):
            base_logits = linear_rows(hidden, lm_head_weight.to(hidden.dtype))
            prev_emb = F.embedding(prev_ids_c, embed_weight)
            final_logits = draft.apply_logits_head(
                base_logits, prev_token_embeddings=prev_emb,
                hidden_states=hidden)
            final_ce = masked_cross_entropy(final_logits, target_ids_c)
            base_ce = masked_cross_entropy(base_logits, target_ids_c)
            predicted = final_logits.argmax(dim=-1)
            base_pred = base_logits.argmax(dim=-1)
            bin_mask = ew_mask > 0.5
            valid_mask = ew_mask > 0
            accepted = compute_accept_len(predicted, target_ids_c, valid_mask)
            base_accepted = compute_accept_len(base_pred, target_ids_c,
                                               valid_mask)
            valid_blocks = valid_mask.any(dim=-1).float()
            return (
                torch.sum(final_ce * w_mask), torch.sum(base_ce * w_mask),
                torch.sum(w_mask),
                ((predicted == target_ids_c) & bin_mask).float().sum(),
                ((base_pred == target_ids_c) & bin_mask).float().sum(),
                torch.sum(ew_mask),
                torch.sum((accepted + 1.0) * valid_blocks),
                torch.sum((base_accepted + 1.0) * valid_blocks),
                torch.sum(valid_blocks),
            )

        (final_num, base_num, loss_den, correct_num, base_correct,
         accuracy_den, accept_num, base_accept_num, accept_den) = (
            checkpointed_chunk_reduce(
                chunk_fn, hidden4d, prev_ids, target_ids, weight_mask,
                eval_weight_mask, chunk_size=self.objective_chunk_blocks,
                axis=1))
        valid_token_count = loss_den + 1e-6
        final_loss = final_num / valid_token_count
        base_loss = base_num / valid_token_count
        loss = (1.0 - lambda_base) * final_loss + lambda_base * base_loss
        return self._domino_outputs(
            loss, final_loss, base_loss, correct_num, base_correct,
            accuracy_den, accept_num, base_accept_num, accept_den, lambda_base)

    @staticmethod
    def _domino_outputs(loss, final_loss, base_loss, correct_num, base_correct,
                        accuracy_den, accept_num, base_accept_num, accept_den,
                        lambda_base):
        accuracy = correct_num / (accuracy_den + 1e-6)
        metrics = {
            "final_loss": final_loss.detach(),
            "base_loss": base_loss.detach(),
            "base_accuracy": (base_correct / (accuracy_den + 1e-6)).detach(),
            "accept_len": accept_num / (accept_den + 1e-6),
            "base_accept_len": base_accept_num / (accept_den + 1e-6),
            "lambda_base": torch.tensor(float(lambda_base),
                                        dtype=torch.float32,
                                        device=loss.device),
            "accuracy_denom": accuracy_den,
        }
        return loss, accuracy, metrics
