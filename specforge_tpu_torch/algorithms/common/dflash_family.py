"""DFlash-family training wrappers (DFlash, Domino and DSpark).

Counterpart of ``OnlineDFlashModel``, ``OnlineDominoModel`` and
``OnlineDSparkModel`` in ``specforge_tpu/algorithms/common/dflash_family.py``:
anchors from doubly supervised positions, mask-token query blocks,
same-position labels (block position k → token anchor+k, or anchor+1+k under
Domino's ``shift_label`` and for DSpark), the frozen target
``lm_head``/``embed_tokens`` passed in as tensors, and the per-family
losses:

- DFlash: masked CE (optional exponential position decay, optional D-PACE
  confidence weights) with the ``loss_terms`` (numerator, denominator)
  contract for normalising the gradient over the accumulation window;
- Domino: GRU-corrected final CE blended with the base CE by a decaying
  ``lambda_base``; per-block accept-length telemetry;
- DSpark: Markov-corrected CE + L1(draft probs, teacher probs) +
  confidence-head BCE, token-pooled over one global denominator, with nine
  ratio metrics.

``forward`` samples the anchors from ``generator`` (a ``torch.Generator``)
unless ``anchors=(positions, keep)`` is given; the parity tests hand in the
anchors the JAX sampler drew. On a mesh (``mesh``, set by the composition)
every sum a loss or metric divides is summed over all ranks first
(``mesh_sums``), so each is the global batch's value on every rank and
each rank's gradient its own share. The vocab objective is the fused one
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
    dspark_objective_fused,
    linear_rows,
    masked_cross_entropy,
)
from specforge_tpu_torch.ops.masks import sample_anchor_positions
from specforge_tpu_torch.parallel.usp import mesh_sums

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
        #: the rank grid whose ranks hold the rest of the global batch
        self.mesh = None

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
        loss_num, loss_denominator, correct_num, accuracy_den = mesh_sums(
            (loss_num, loss_denominator, correct_num, accuracy_den),
            self.mesh)
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
             accept_den) = mesh_sums(domino_objective_fused(
                hidden4d, corr_act, draft.logits_head_kernel(), target_ids,
                weight_mask, eval_weight_mask, lambda_base, lm_head_weight,
                self.objective_chunk_blocks), self.mesh)
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
         accuracy_den, accept_num, base_accept_num, accept_den) = mesh_sums(
            checkpointed_chunk_reduce(
                chunk_fn, hidden4d, prev_ids, target_ids, weight_mask,
                eval_weight_mask, chunk_size=self.objective_chunk_blocks,
                axis=1), self.mesh)
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


def _confidence_bce(conf_pred, accept_probability, loss_weights):
    """(BCE numerator, |sigmoid - p| numerator) of the confidence head's
    logits against the (constant) acceptance probability."""
    ap = accept_probability.detach()
    logits = conf_pred.float()
    per_token = (torch.clamp(logits, min=0) - logits * ap
                 + torch.log1p(torch.exp(-logits.abs())))
    return ((per_token * loss_weights).sum(),
            ((torch.sigmoid(logits) - ap).abs() * loss_weights).sum())


class OnlineDSparkModel(OnlineDFlashModel):
    """DSpark: Markov-corrected CE + L1 to the teacher's probabilities +
    confidence BCE."""

    def __init__(self, draft_model, mask_token_id: int,
                 dspark_ce_loss_alpha: float = 0.1,
                 dspark_l1_loss_alpha: float = 0.9,
                 dspark_confidence_head_alpha: float = 1.0, **kwargs):
        super().__init__(draft_model, mask_token_id, **kwargs)
        self.dspark_ce_loss_alpha = float(dspark_ce_loss_alpha)
        self.dspark_l1_loss_alpha = float(dspark_l1_loss_alpha)
        self.dspark_confidence_head_alpha = float(dspark_confidence_head_alpha)

    def _labels_and_mask(self, input_ids, loss_mask, anchor_positions, keep):
        """Labels at anchor+1+k (0 in blocks not kept), the eval mask (a
        cumulative product over the block) and the clamped label indices."""
        b, seq_len = input_ids.shape
        offsets = torch.arange(1, self.block_size + 1,
                               device=input_ids.device)
        label_indices = anchor_positions.long()[..., None] + offsets
        safe = label_indices.clamp(0, seq_len - 1)
        safe = torch.where(keep[..., None], safe, torch.zeros_like(safe))
        target_ids = input_ids.long().gather(1, safe.view(b, -1)).view(
            safe.shape)
        eval_mask = ((label_indices < seq_len)
                     & (self._gather_loss_mask(loss_mask, safe) > 0.5)
                     & keep[..., None])
        eval_mask = torch.cumprod(eval_mask.to(torch.int32), dim=-1) > 0
        return target_ids, eval_mask, safe

    def forward(
        self,
        input_ids,
        hidden_states,
        loss_mask,
        lm_head_weight,
        embed_weight,
        generator: Optional[torch.Generator] = None,
        target_last_hidden_states: Optional[torch.Tensor] = None,
        *,
        anchors: Optional[Anchors] = None,
    ):
        b, seq_len = input_ids.shape
        if loss_mask.dim() == 3:
            loss_mask = loss_mask[..., 0]
        anchor_positions, keep, output_hidden = self._forward_draft_blocks(
            input_ids, hidden_states, loss_mask, embed_weight, generator,
            anchors)
        target_ids, eval_mask, safe = self._labels_and_mask(
            input_ids, loss_mask, anchor_positions, keep)
        anchor_tokens = input_ids.long().gather(
            1, anchor_positions.long().clamp(0, seq_len - 1))
        prev_token_ids = torch.cat([anchor_tokens[..., None],
                                    target_ids[..., :-1]], dim=-1)
        n = anchor_positions.shape[1]
        hidden_4d = output_hidden.view(b, n, self.block_size, -1)
        loss_weights = eval_mask.float()
        decay = self._decay(0, input_ids.device)
        if decay is not None:
            loss_weights = loss_weights * decay
        loss_den = loss_weights.sum()

        aligned = None
        need_target = (self.dspark_l1_loss_alpha > 0
                       or self.dspark_confidence_head_alpha > 0)
        if need_target and target_last_hidden_states is not None:
            # the target state that predicts each label token sits one
            # position before it; in the compute dtype (features keep
            # their stored one)
            pred_idx = torch.clamp(safe - 1, min=0).view(b, -1)
            h = target_last_hidden_states.shape[-1]
            aligned = target_last_hidden_states.gather(
                1, pred_idx[..., None].expand(-1, -1, h)).view(
                    b, n, self.block_size, h).to(hidden_4d.dtype)

        if self.fused_objective:
            return self._fused_call(hidden_4d, prev_token_ids, target_ids,
                                    loss_weights, eval_mask, aligned,
                                    lm_head_weight, loss_den)
        totals = checkpointed_chunk_reduce(
            self._chunk_terms(lm_head_weight), hidden_4d, prev_token_ids,
            target_ids, loss_weights, eval_mask, aligned,
            chunk_size=self.objective_chunk_blocks, axis=1)
        (ce_num, l1_num, conf_num, conf_err, correct_num, eval_den, agree_num,
         t_top1, d_top1, tau_num, tau_den, loss_den) = mesh_sums(
            totals[:6] + totals[9:] + (loss_den,), self.mesh)
        global_den = torch.clamp(loss_den.detach(), min=1e-6)
        loss = (self.dspark_ce_loss_alpha * ce_num
                + self.dspark_l1_loss_alpha * l1_num
                + self.dspark_confidence_head_alpha * conf_num) / global_den
        return self._dspark_outputs(
            loss, ce_num, l1_num, conf_num, conf_err, correct_num, eval_den,
            agree_num, t_top1, d_top1, tau_num, tau_den, loss_den)

    def _chunk_terms(self, lm_head_weight):
        """The unfused objective of one anchor chunk (checkpointed: its
        logits are recomputed in the backward pass)."""
        draft = self.draft_model

        def fn(hidden, prev_ids, target_ids, lw, em, ath):
            base_logits = linear_rows(hidden, lm_head_weight.to(hidden.dtype))
            draft_logits = draft.apply_logits_head(
                base_logits, prev_token_ids=prev_ids, hidden_states=hidden)
            ce = masked_cross_entropy(draft_logits, target_ids)
            zero = torch.zeros((), device=hidden.device)
            l1_num = conf_num = conf_err = zero
            agree_num = t_top1 = d_top1 = tau_num = tau_den = zero
            accept_probability = None
            emf = em.float()
            predicted = draft_logits.argmax(dim=-1)
            if ath is not None:
                target_logits = linear_rows(
                    ath, lm_head_weight.to(ath.dtype)).detach()
                target_probs = torch.softmax(target_logits.float(), dim=-1)
                teacher_ids = target_logits.argmax(dim=-1)
                draft_probs = torch.softmax(draft_logits.float(), dim=-1)
                l1_per_token = (draft_probs - target_probs).abs().sum(dim=-1)
                accept_probability = torch.clamp(1.0 - 0.5 * l1_per_token,
                                                 0.0, 1.0)
                if self.dspark_l1_loss_alpha > 0:
                    l1_num = (l1_per_token * lw).sum()
                agree_num = ((predicted == teacher_ids).float() * emf).sum()
                t_top1 = (target_probs.amax(dim=-1) * emf).sum()
                d_top1 = (draft_probs.amax(dim=-1).detach() * emf).sum()
                valid_blocks = em.any(dim=-1).float()
                accepted_exp = torch.cumprod(
                    accept_probability.detach() * emf, dim=-1).sum(dim=-1)
                tau_num = ((accepted_exp + 1.0) * valid_blocks).sum()
                tau_den = valid_blocks.sum()
            conf_pred = draft.predict_confidence(hidden,
                                                 prev_token_ids=prev_ids)
            if (conf_pred is not None
                    and self.dspark_confidence_head_alpha > 0):
                if accept_probability is None:
                    raise ValueError("DSpark confidence loss requires "
                                     "target_last_hidden_states")
                conf_num, conf_err = _confidence_bce(
                    conf_pred, accept_probability, lw)
            correct = ((predicted == target_ids) & em).float()
            return (
                (ce * lw).sum(), l1_num, conf_num, conf_err.detach(),
                correct.sum(), emf.sum(),
                (ce.detach() * emf).sum(dim=(0, 1)),
                correct.sum(dim=(0, 1)), emf.sum(dim=(0, 1)), agree_num,
                t_top1, d_top1, tau_num, tau_den,
            )

        return fn

    def _fused_call(self, hidden_4d, prev_token_ids, target_ids, loss_weights,
                    eval_mask, aligned, lm_head_weight, loss_den):
        """The fused objective: the draft's and the teacher's full-vocab
        softmaxes run once each inside :func:`dspark_objective_fused`; the
        small confidence BCE is ordinary autograd outside it, on the op's
        constant acceptance probability."""
        draft = self.draft_model
        (vocab_num, ce_num, l1_num, correct_num, eval_den, _ce_pos,
         _correct_pos, _pos_den, agree_num, t_top1, d_top1, tau_num, tau_den,
         accept_probability) = dspark_objective_fused(
            hidden_4d, draft.markov_latents(prev_token_ids, hidden_4d),
            draft.markov_kernel(), aligned, target_ids, loss_weights,
            eval_mask, lm_head_weight, self.dspark_ce_loss_alpha,
            self.dspark_l1_loss_alpha, self.objective_chunk_blocks)
        zero = torch.zeros((), device=hidden_4d.device)
        conf_num = conf_err = zero
        conf_pred = draft.predict_confidence(hidden_4d,
                                             prev_token_ids=prev_token_ids)
        if conf_pred is not None and self.dspark_confidence_head_alpha > 0:
            if aligned is None:
                raise ValueError("DSpark confidence loss requires "
                                 "target_last_hidden_states")
            conf_num, conf_err = _confidence_bce(conf_pred,
                                                 accept_probability,
                                                 loss_weights)
        (vocab_num, ce_num, l1_num, conf_num, conf_err, correct_num, eval_den,
         agree_num, t_top1, d_top1, tau_num, tau_den, loss_den) = mesh_sums(
            (vocab_num, ce_num, l1_num, conf_num, conf_err, correct_num,
             eval_den, agree_num, t_top1, d_top1, tau_num, tau_den, loss_den),
            self.mesh)
        global_den = torch.clamp(loss_den.detach(), min=1e-6)
        loss = (vocab_num
                + self.dspark_confidence_head_alpha * conf_num) / global_den
        return self._dspark_outputs(
            loss, ce_num, l1_num, conf_num, conf_err.detach(), correct_num,
            eval_den, agree_num, t_top1, d_top1, tau_num, tau_den, loss_den)

    @staticmethod
    def _dspark_outputs(loss, ce_num, l1_num, conf_num, conf_err, correct_num,
                        eval_den, agree_num, t_top1, d_top1, tau_num, tau_den,
                        loss_den):
        ratio_metrics = {
            "acc": (correct_num, eval_den),
            "ce_loss": (ce_num.detach(), loss_den),
            "l1_loss": (l1_num.detach(), loss_den),
            "confidence_loss": (conf_num.detach(), loss_den),
            "confidence_abs_error": (conf_err, loss_den),
            "teacher_agreement": (agree_num, eval_den),
            "teacher_top1_prob": (t_top1, eval_den),
            "draft_top1_prob": (d_top1, eval_den),
            "tau_probabilistic": (tau_num, tau_den),
        }
        accuracy = correct_num / torch.clamp(eval_den, min=1.0)
        return loss, accuracy, {"ratio_metrics": ratio_metrics,
                                "accuracy_denom": eval_den}
