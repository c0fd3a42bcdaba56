"""DFlash draft model — an N-layer Qwen3-style block-diffusion decoder.

Counterpart of ``specforge_tpu/models/draft/dflash.py``, with the same module
names, so weights carry over (``specforge_tpu_torch.convert``). Per layer,
the draft (mask-token) queries attend to a shared projected target-hidden
context, as a key/value prefix, plus their own block's draft keys; the
context stream is never updated. Attention has per-head q/k RMSNorms and
RoPE on the context and draft positions; ``layer_types`` picks full or
sliding-window layers.

- ``qkv_proj`` and ``gate_up_proj`` are merged, as in the JAX draft; the
  context stream multiplies only the k/v rows of the merged weight.
- ``attention_backend`` (the draft config's key): ``"auto"`` or
  ``"pallas"`` is the hand-written DFlash kernel
  (:func:`specforge_tpu_torch.ops.dflash_attention_cuda.dflash_flash_attention`,
  its plain version on CPU tensors); ``"chunked"`` is the plain chunked path
  (:func:`specforge_tpu_torch.ops.attention.dflash_attention`). The JAX
  package's TPU crossover between the two is TPU tuning and not ported.

Parameters are fp32; every matrix product runs in ``dtype``; RMSNorm
computes its statistics in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from specforge_tpu_torch.models.draft.base import DraftModelConfig
from specforge_tpu_torch.models.draft.llama_eagle3 import ACT_FNS, Linear, RMSNorm
from specforge_tpu_torch.ops.attention import dflash_attention
from specforge_tpu_torch.ops.dflash_attention_cuda import dflash_flash_attention
from specforge_tpu_torch.ops.rope import (
    RopeSpec,
    apply_rope,
    rope_cos_sin,
    rotate_half,
)
from specforge_tpu_torch.utils import DeviceLike, resolve_device

FULL_ATTENTION = "full_attention"
SLIDING_ATTENTION = "sliding_attention"
ATTENTION_BACKENDS = ("auto", "pallas", "chunked")


def build_target_layer_ids(num_target_layers: int, num_draft_layers: int):
    """Evenly spaced capture layers."""
    if num_draft_layers == 1:
        return [num_target_layers // 2]
    start, end = 1, num_target_layers - 3
    span = end - start
    return [
        int(round(start + (i * span) / (num_draft_layers - 1)))
        for i in range(num_draft_layers)
    ]


@dataclass(frozen=True)
class DFlashConfig(DraftModelConfig):
    block_size: int = 16
    num_target_layers: int = 36
    layer_types: Tuple[str, ...] = ()
    sliding_window: Optional[int] = None
    attention_bias: bool = False
    # dflash_config sub-dict of the reference configs
    mask_token_id: Optional[int] = None
    target_layer_ids: Optional[Tuple[int, ...]] = None
    projector_type: Optional[str] = None
    pure_draft_prefix_len: int = 0
    shift_label: bool = False
    # domino head
    emb_dim: int = 0
    gru_hidden_dim: int = 0
    # dspark heads
    markov_rank: int = 0
    markov_head_type: str = "vanilla"
    enable_confidence_head: bool = False
    confidence_head_with_markov: bool = False

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "DFlashConfig":
        """Merge the ``dflash_config`` sub-dict into the top level, keep the
        known keys, and validate ``layer_types``."""
        obj = dict(obj)
        dflash_cfg = obj.pop("dflash_config", {}) or {}
        merged = {**obj, **dflash_cfg}
        known = cls.field_names()
        kwargs = {k: v for k, v in merged.items() if k in known}
        for key in ("architectures", "layer_types", "target_layer_ids"):
            if kwargs.get(key) is not None:
                kwargs[key] = tuple(kwargs[key])
        cfg = cls(**kwargs)
        cfg.validate_layout()
        return cfg

    def validate_layout(self) -> None:
        if not self.layer_types:
            return
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(
                "layer_types must have num_hidden_layers="
                f"{self.num_hidden_layers} entries, got {len(self.layer_types)}"
            )
        invalid = set(self.layer_types) - {FULL_ATTENTION, SLIDING_ATTENTION}
        if invalid:
            raise ValueError(f"unsupported layer_types {sorted(invalid)}")
        if SLIDING_ATTENTION in self.layer_types and not (
            self.sliding_window and self.sliding_window > 0
        ):
            raise ValueError(
                "sliding_attention layers require a positive sliding_window"
            )

    @property
    def resolved_layer_types(self) -> Tuple[str, ...]:
        return self.layer_types or (FULL_ATTENTION,) * self.num_hidden_layers

    @property
    def resolved_target_layer_ids(self) -> Tuple[int, ...]:
        if self.target_layer_ids is not None:
            return tuple(self.target_layer_ids)
        return tuple(
            build_target_layer_ids(self.num_target_layers,
                                   self.num_hidden_layers)
        )


class DFlashAttention(nn.Module):
    def __init__(self, config: DFlashConfig, layer_idx: int, dtype,
                 attention_backend: str, attn_chunk_blocks: int, device=None):
        super().__init__()
        if attention_backend not in ATTENTION_BACKENDS:
            raise ValueError(
                f"attention_backend {attention_backend!r} not in "
                f"{ATTENTION_BACKENDS}"
            )
        self.config = config
        self.dtype = dtype
        self.attention_backend = attention_backend
        self.attn_chunk_blocks = attn_chunk_blocks
        d = config.resolved_head_dim
        h, kvh = config.num_attention_heads, config.num_key_value_heads
        self.qkv_proj = Linear(config.hidden_size, (h + 2 * kvh) * d, dtype,
                               device, bias=config.attention_bias)
        self.o_proj = Linear(h * d, config.hidden_size, dtype, device,
                             bias=config.attention_bias)
        self.q_norm = RMSNorm(d, config.rms_norm_eps, device)
        self.k_norm = RMSNorm(d, config.rms_norm_eps, device)
        self.rope_spec = RopeSpec.from_config(config)
        self.sliding_window = (
            config.sliding_window
            if config.resolved_layer_types[layer_idx] == SLIDING_ATTENTION
            else None
        )

    def forward(
        self,
        draft_hidden: torch.Tensor,        # [B, Q, h]
        context_hidden: torch.Tensor,      # [B, S, h]
        ctx_position_ids: torch.Tensor,    # [B, S]
        draft_position_ids: torch.Tensor,  # [B, Q]
        anchor_positions: torch.Tensor,    # [B, N]
        block_keep_mask: torch.Tensor,     # [B, N]
    ) -> torch.Tensor:
        cfg = self.config
        b, q_len, _ = draft_hidden.shape
        s = context_hidden.shape[1]
        d = cfg.resolved_head_dim
        h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
        qc, kc = h * d, kvh * d
        weight = self.qkv_proj.weight.to(self.dtype)
        bias = self.qkv_proj.bias
        bias = None if bias is None else bias.to(self.dtype)
        qkv = F.linear(draft_hidden.to(self.dtype), weight, bias)
        kv_ctx = F.linear(context_hidden.to(self.dtype), weight[qc:],
                          None if bias is None else bias[qc:])
        # per-head norms over the last dim, in [B, T, heads, d]
        q = self.q_norm(qkv[..., :qc].reshape(b, q_len, h, d)).transpose(1, 2)
        k_drf = self.k_norm(qkv[..., qc:qc + kc].reshape(b, q_len, kvh, d))
        k_drf = k_drf.transpose(1, 2)
        k_ctx = self.k_norm(kv_ctx[..., :kc].reshape(b, s, kvh, d))
        k_ctx = k_ctx.transpose(1, 2)
        v_ctx = kv_ctx[..., kc:].reshape(b, s, kvh, d).transpose(1, 2)
        v_drf = qkv[..., qc + kc:].reshape(b, q_len, kvh, d).transpose(1, 2)

        cos_c, sin_c = rope_cos_sin(self.rope_spec, ctx_position_ids, s,
                                    dtype=q.dtype)
        cos_d, sin_d = rope_cos_sin(self.rope_spec, draft_position_ids, q_len,
                                    dtype=q.dtype)
        q, k_drf = apply_rope(q, k_drf, cos_d, sin_d)
        # context keys rotate by their own positions
        k_ctx = k_ctx * cos_c[:, None] + rotate_half(k_ctx) * sin_c[:, None]

        if self.attention_backend == "chunked":
            attn = dflash_attention(
                q, k_ctx, v_ctx, k_drf, v_drf, anchor_positions,
                block_keep_mask, cfg.block_size,
                chunk_blocks=self.attn_chunk_blocks,
                sliding_window=self.sliding_window,
            )
        else:
            attn = dflash_flash_attention(
                q, k_ctx, v_ctx, k_drf, v_drf, anchor_positions,
                block_keep_mask, cfg.block_size, self.sliding_window,
            )
        return self.o_proj(attn)


class DFlashMLP(nn.Module):
    def __init__(self, config: DFlashConfig, dtype, device=None):
        super().__init__()
        f = config.intermediate_size
        self.act = ACT_FNS[config.hidden_act]
        self.gate_up_proj = Linear(config.hidden_size, 2 * f, dtype, device)
        self.down_proj = Linear(f, config.hidden_size, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(self.act(gate) * up)


class DFlashDecoderLayer(nn.Module):
    def __init__(self, config: DFlashConfig, layer_idx: int, dtype,
                 attention_backend: str, attn_chunk_blocks: int, device=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.self_attn = DFlashAttention(config, layer_idx, dtype,
                                         attention_backend, attn_chunk_blocks,
                                         device)
        self.mlp = DFlashMLP(config, dtype, device)
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps, device)

    def forward(self, draft_hidden, context_hidden, ctx_position_ids,
                draft_position_ids, anchor_positions, block_keep_mask):
        residual = draft_hidden
        x = self.self_attn(
            self.input_layernorm(draft_hidden), context_hidden,
            ctx_position_ids, draft_position_ids, anchor_positions,
            block_keep_mask,
        )
        draft_hidden = residual + x
        return draft_hidden + self.mlp(
            self.post_attention_layernorm(draft_hidden))


class DFlashDraftModel(nn.Module):
    """DFlash draft. ``device`` defaults to CUDA (and raises without it);
    weights are drawn from a generator on that device seeded with ``seed``.
    The layers are ``layers_0`` … ``layers_{L-1}``, the JAX names."""

    def __init__(
        self,
        config: DFlashConfig,
        dtype: torch.dtype = torch.bfloat16,
        attention_backend: str = "auto",
        attn_chunk_blocks: int = 8,
        device: DeviceLike = None,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        self.attention_backend = attention_backend
        self.num_layers = config.num_hidden_layers
        for i in range(config.num_hidden_layers):
            setattr(self, f"layers_{i}", DFlashDecoderLayer(
                config, i, dtype, attention_backend, attn_chunk_blocks,
                device))
        n_capture = len(config.resolved_target_layer_ids)
        self.fc = Linear(n_capture * config.hidden_size, config.hidden_size,
                         dtype, device)
        self.hidden_norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                                   device)
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)
        self._init_draft_head(device)
        self.reset_parameters(
            torch.Generator(device=device).manual_seed(seed))

    def _init_draft_head(self, device) -> None:
        """Override point for the Domino and DSpark heads."""

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init: fan-in-scaled normal weight matrices, unit norm
        weights, zero biases."""
        for name, p in self.named_parameters():
            if p.dim() == 2:
                p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)

    @property
    def layers(self):
        return [getattr(self, f"layers_{i}") for i in range(self.num_layers)]

    def project_context(self, target_hidden: torch.Tensor) -> torch.Tensor:
        """[B, S, L*hidden] capture concat → normed [B, S, hidden] context."""
        return self.hidden_norm(self.fc(target_hidden))

    def forward(
        self,
        noise_embedding: torch.Tensor,     # [B, N*block, h] mask-token embeds
        target_hidden: torch.Tensor,       # [B, S, L*h] capture concat
        ctx_position_ids: torch.Tensor,
        draft_position_ids: torch.Tensor,
        anchor_positions: torch.Tensor,
        block_keep_mask: torch.Tensor,
    ) -> torch.Tensor:
        hidden = noise_embedding.to(self.dtype)
        context = self.project_context(target_hidden.to(self.dtype))
        for layer in self.layers:
            hidden = layer(hidden, context, ctx_position_ids,
                           draft_position_ids, anchor_positions,
                           block_keep_mask)
        return self.norm(hidden)

    # --- auxiliary-head seams (overridden by Domino and DSpark) -----------
    def predict_confidence(self, hidden_states: torch.Tensor, *,
                           prev_token_ids: Optional[torch.Tensor] = None
                           ) -> Optional[torch.Tensor]:
        """Per-position acceptance logits; the base draft has no head."""
        return None
