"""DSpark draft model: the DFlash backbone, a Markov logit bias and a
confidence head.

Counterpart of ``specforge_tpu/models/draft/dspark.py``, with the same
module names, so weights carry over (``specforge_tpu_torch.convert``). A
Markov head adds a low-rank bias from the previous token to the base
(frozen target head) logits: ``vanilla`` (the previous token's rank-r
embedding), ``gated`` (that embedding under a sigmoid gate on the hidden
state) or ``rnn`` (a minimal recurrent cell unrolled over a block). The
confidence head predicts each position's acceptance probability, from the
hidden state and, with ``confidence_head_with_markov``, the previous token's
Markov embedding.

``markov_w1`` is an embedding table [V, r]; ``markov_w2`` is the bias
projection, a [V, r] weight used as ``latent @ weight^T`` (the JAX [r, V]
kernel, transposed), which the fused objective multiplies directly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from specforge_tpu_torch.models.draft.dflash import DFlashDraftModel
from specforge_tpu_torch.models.draft.llama_eagle3 import Linear
from specforge_tpu_torch.ops.fused_objective import linear_rows


class VanillaMarkovHead(nn.Module):
    """The previous token's rank-r embedding as the latent."""

    def __init__(self, vocab_size: int, markov_rank: int, hidden_size: int,
                 dtype, device=None):
        super().__init__()
        self.markov_rank = markov_rank
        self.dtype = dtype
        self.markov_w1 = nn.Embedding(vocab_size, markov_rank, device=device)
        self.markov_w2 = Linear(markov_rank, vocab_size, dtype, device)

    def get_prev_embeddings(self, token_ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(token_ids.long(), self.markov_w1.weight).to(
            self.dtype)

    def w2_kernel(self) -> torch.Tensor:
        """The trainable bias projection [V, r] (logit bias = latent @ w^T)."""
        return self.markov_w2.weight

    def project_bias(self, latent: torch.Tensor) -> torch.Tensor:
        return linear_rows(latent.to(self.dtype),
                           self.markov_w2.weight.to(self.dtype))

    def block_latents(self, token_ids: torch.Tensor,
                      hidden_states: Optional[torch.Tensor]) -> torch.Tensor:
        """The pre-``markov_w2`` latent [..., block, r]; the logit bias is
        ``project_bias(block_latents(...))``."""
        return self.get_prev_embeddings(token_ids)

    def apply_block_logits(self, base_logits: torch.Tensor, *,
                           token_ids: torch.Tensor,
                           hidden_states: Optional[torch.Tensor]
                           ) -> torch.Tensor:
        """base_logits [..., block, V]; token_ids [..., block], the previous
        tokens."""
        latent = self.block_latents(token_ids, hidden_states)
        return base_logits + self.project_bias(latent).to(base_logits.dtype)


class GatedMarkovHead(VanillaMarkovHead):
    """The embedding under a sigmoid gate on concat(hidden, embedding)."""

    def __init__(self, vocab_size: int, markov_rank: int, hidden_size: int,
                 dtype, device=None):
        super().__init__(vocab_size, markov_rank, hidden_size, dtype, device)
        self.gate_proj = Linear(hidden_size + markov_rank, markov_rank, dtype,
                                device, bias=True)

    def block_latents(self, token_ids, hidden_states):
        if hidden_states is None:
            raise ValueError("gated Markov head requires hidden_states")
        prev = self.get_prev_embeddings(token_ids)
        gate_in = torch.cat([hidden_states.to(prev.dtype), prev], dim=-1)
        gate = torch.sigmoid(self.gate_proj(gate_in)).to(prev.dtype)
        return gate * prev


class RNNMarkovHead(VanillaMarkovHead):
    """A minimal recurrent cell over the block: ``joint_proj`` maps
    concat(state, embedding, hidden) to a gate, a candidate and an output."""

    def __init__(self, vocab_size: int, markov_rank: int, hidden_size: int,
                 dtype, device=None):
        super().__init__(vocab_size, markov_rank, hidden_size, dtype, device)
        self.joint_proj = Linear(2 * markov_rank + hidden_size,
                                 3 * markov_rank, dtype, device, bias=True)

    def block_latents(self, token_ids, hidden_states):
        if hidden_states is None:
            raise ValueError("rnn Markov head requires hidden_states")
        r = self.markov_rank
        prev_all = self.get_prev_embeddings(token_ids)   # [.., block, r]
        hid = hidden_states.to(prev_all.dtype)
        weight = self.joint_proj.weight.to(self.dtype)
        # joint_proj is linear over concat(state, embedding, hidden): the
        # embedding and hidden part (and the bias) does not depend on the
        # recurrence, so it is one product over every step (the JAX head's
        # product with a zero state slot); only state @ K[:r] stays in the
        # unrolled loop, K[:r] being weight[:, :r] in torch's [out, in]
        static = linear_rows(torch.cat([prev_all, hid], dim=-1),
                             weight[:, r:])
        static = static + self.joint_proj.bias.to(self.dtype)
        k_state = weight[:, :r]
        state = torch.zeros((*token_ids.shape[:-1], r), dtype=self.dtype,
                            device=prev_all.device)
        outs = []
        for step in range(token_ids.shape[-1]):
            raw = static[..., step, :] + F.linear(state, k_state)
            gate = torch.sigmoid(raw[..., :r])
            candidate = torch.tanh(raw[..., r:2 * r])
            outs.append(torch.tanh(raw[..., 2 * r:]))
            state = gate * state + (1.0 - gate) * candidate
        return torch.stack(outs, dim=-2)


class AcceptRatePredictor(nn.Module):
    """Per-position acceptance-probability logit: one projection to 1."""

    def __init__(self, in_features: int, dtype, device=None):
        super().__init__()
        self.proj = Linear(in_features, 1, dtype, device, bias=True)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.proj(features)[..., 0]


MARKOV_HEADS = {
    "vanilla": VanillaMarkovHead,
    "gated": GatedMarkovHead,
    "rnn": RNNMarkovHead,
}


class DSparkDraftModel(DFlashDraftModel):
    """DFlash backbone with DSpark's Markov and confidence heads."""

    def _init_draft_head(self, device) -> None:
        cfg = self.config
        if cfg.projector_type not in (None, "dspark"):
            raise ValueError(
                "DSparkDraftModel requires projector_type='dspark', got "
                f"{cfg.projector_type!r}"
            )
        self.markov_head = None
        if cfg.markov_rank > 0:
            if cfg.markov_head_type not in MARKOV_HEADS:
                raise ValueError(
                    f"markov_head_type {cfg.markov_head_type!r} not in "
                    f"{sorted(MARKOV_HEADS)}")
            self.markov_head = MARKOV_HEADS[cfg.markov_head_type](
                cfg.vocab_size, cfg.markov_rank, cfg.hidden_size, self.dtype,
                device)
        if cfg.confidence_head_with_markov and self.markov_head is None:
            raise ValueError(
                "confidence_head_with_markov=True requires markov_rank > 0")
        self.confidence_head = None
        if cfg.enable_confidence_head:
            width = cfg.hidden_size + (
                cfg.markov_rank if cfg.confidence_head_with_markov else 0)
            self.confidence_head = AcceptRatePredictor(width, self.dtype,
                                                       device)

    def apply_logits_head(self, base_logits: torch.Tensor, *,
                          prev_token_ids: Optional[torch.Tensor] = None,
                          hidden_states: torch.Tensor) -> torch.Tensor:
        if self.markov_head is None:
            return base_logits
        if prev_token_ids is None:
            raise ValueError("DSparkDraftModel requires prev_token_ids")
        return self.markov_head.apply_block_logits(
            base_logits, token_ids=prev_token_ids,
            hidden_states=hidden_states)

    def markov_latents(self, prev_token_ids: torch.Tensor,
                       hidden_states: torch.Tensor) -> Optional[torch.Tensor]:
        """The pre-projection Markov latent [..., block, r] (None without a
        head)."""
        if self.markov_head is None:
            return None
        return self.markov_head.block_latents(prev_token_ids, hidden_states)

    def markov_kernel(self) -> Optional[torch.Tensor]:
        """The trainable Markov bias projection [V, r] (None without a
        head)."""
        if self.markov_head is None:
            return None
        return self.markov_head.w2_kernel()

    def predict_confidence(self, hidden_states: torch.Tensor, *,
                           prev_token_ids: Optional[torch.Tensor] = None
                           ) -> Optional[torch.Tensor]:
        if self.confidence_head is None:
            return None
        if self.config.confidence_head_with_markov:
            if prev_token_ids is None:
                raise ValueError(
                    "prev_token_ids is required for Markov confidence")
            prev = self.markov_head.get_prev_embeddings(prev_token_ids).to(
                hidden_states.dtype)
            hidden_states = torch.cat([hidden_states, prev], dim=-1)
        return self.confidence_head(hidden_states)
