"""Domino draft model: the DFlash backbone plus a GRU logits correction.

Counterpart of ``specforge_tpu/models/draft/domino.py``. The base draft
logits come from the frozen target ``lm_head``; Domino adds a correction
from a single-layer, bias-free GRU over the previous tokens' embeddings,
concatenated with the draft hidden state and projected through a SiLU MLP
to the vocabulary (``embed_proj_0`` then ``embed_proj_1``). Block positions
before ``suffix_start`` get no correction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from specforge_tpu_torch.models.draft.dflash import DFlashDraftModel
from specforge_tpu_torch.models.draft.llama_eagle3 import Linear
from specforge_tpu_torch.ops.fused_objective import linear_rows


class GRU(nn.Module):
    """Bias-free single-layer GRU with torch.nn.GRU(bias=False)'s equations:

        r = σ(W_ir x + W_hr h);  z = σ(W_iz x + W_hz h)
        n = tanh(W_in x + r ⊙ (W_hn h));  h' = (1 - z) ⊙ n + z ⊙ h

    ``weight_ih`` [3·hd, in] and ``weight_hh`` [3·hd, hd] (torch's layout,
    as in the JAX module); products in ``dtype``. The input projection of
    every step is one product, hoisted out of the recurrence."""

    def __init__(self, input_dim: int, hidden_dim: int, dtype, device=None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.dtype = dtype
        self.weight_ih = nn.Parameter(
            torch.empty(3 * hidden_dim, input_dim, device=device))
        self.weight_hh = nn.Parameter(
            torch.empty(3 * hidden_dim, hidden_dim, device=device))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """xs [batch, time, input] → outputs [batch, time, hidden]."""
        hd = self.hidden_dim
        w_hh = self.weight_hh.to(self.dtype)
        gi_all = F.linear(xs.to(self.dtype), self.weight_ih.to(self.dtype))
        h = torch.zeros((xs.shape[0], hd), dtype=self.dtype, device=xs.device)
        outs = []
        for step in range(xs.shape[1]):
            gi = gi_all[:, step]
            gh = F.linear(h, w_hh)
            r = torch.sigmoid(gi[..., :hd] + gh[..., :hd])
            z = torch.sigmoid(gi[..., hd:2 * hd] + gh[..., hd:2 * hd])
            n = torch.tanh(gi[..., 2 * hd:] + r * gh[..., 2 * hd:])
            h = (1.0 - z) * n + z * h
            outs.append(h)
        return torch.stack(outs, dim=1)


class DominoDraftModel(DFlashDraftModel):
    """DFlash backbone with Domino's GRU logits correction."""

    def _init_draft_head(self, device) -> None:
        cfg = self.config
        if cfg.projector_type not in (None, "domino"):
            raise ValueError(
                "DominoDraftModel requires projector_type='domino', got "
                f"{cfg.projector_type!r}"
            )
        # the GRU reads the target's token embeddings (hidden_size wide)
        self.prefix_gru = GRU(cfg.hidden_size, cfg.gru_hidden_dim, self.dtype,
                              device)
        self.embed_proj_0 = Linear(cfg.hidden_size + cfg.gru_hidden_dim,
                                   cfg.emb_dim, self.dtype, device)
        # JAX keeps a raw [emb, V] kernel used as act @ kernel; here its
        # transpose, a [V, emb] weight used as act @ weight^T
        self.embed_proj_1 = Linear(cfg.emb_dim, cfg.vocab_size, self.dtype,
                                   device)

    @property
    def suffix_start(self) -> int:
        cfg = self.config
        return (cfg.pure_draft_prefix_len if cfg.shift_label
                else 1 + cfg.pure_draft_prefix_len)

    def correction_activation(
        self,
        prev_token_embeddings: torch.Tensor,  # [B, N, block, emb_hidden]
        hidden_states: torch.Tensor,          # [B, N, block, h]
    ) -> torch.Tensor:
        """Pre-``embed_proj_1`` activation [B, N, block, emb_dim], zero
        before ``suffix_start``."""
        cfg = self.config
        b, n, bs = hidden_states.shape[:3]
        start = self.suffix_start
        if cfg.shift_label:
            gru_in = prev_token_embeddings.reshape(b * n, bs, -1)
            gru_out = self.prefix_gru(gru_in).reshape(b, n, bs, -1)
            prefix_states = gru_out[:, :, start:]
        else:
            gru_in = prev_token_embeddings[:, :, :bs - 1].reshape(
                b * n, bs - 1, -1)
            gru_out = self.prefix_gru(gru_in).reshape(b, n, bs - 1, -1)
            prefix_states = gru_out[:, :, start - 1:]
        z_n = hidden_states[:, :, start:]
        concat = torch.cat([z_n, prefix_states.to(z_n.dtype)], dim=-1)
        act = F.silu(self.embed_proj_0(concat))
        pad = torch.zeros((b, n, start, act.shape[-1]), dtype=act.dtype,
                          device=act.device)
        return torch.cat([pad, act], dim=2)

    def logits_head_kernel(self) -> torch.Tensor:
        """The trainable ``embed_proj_1`` weight [V, emb_dim]."""
        return self.embed_proj_1.weight

    def apply_logits_head(self, base_logits: torch.Tensor, *,
                          prev_token_embeddings: torch.Tensor,
                          hidden_states: torch.Tensor) -> torch.Tensor:
        act = self.correction_activation(prev_token_embeddings, hidden_states)
        logits_e = linear_rows(act, self.embed_proj_1.weight.to(act.dtype))
        # the prefix rows of ``act`` are exact zeros
        return base_logits + logits_e.to(base_logits.dtype)
