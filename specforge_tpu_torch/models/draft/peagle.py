"""P-EAGLE draft model — a multi-layer parallel draft over EAGLE3 features.

Counterpart of ``specforge_tpu/models/draft/peagle.py``, with the same module
names, so weights carry over (``specforge_tpu_torch.convert``). The first
layer reads the ``concat(embeds, hidden)`` 2*hidden input (separate norms per
half, as EAGLE3); later layers are standard decoder layers. Unlike EAGLE3 the
embeddings train, and a learned ``mask_hidden`` vector stands in for the
target features at masked (depth > 0) positions.

- ``qkv_proj`` and ``gate_up_proj`` are merged, as in the JAX draft.
- ``attention_backend`` (the draft config's key): ``"auto"`` or ``"pallas"``
  is the hand-written COD kernel
  (:func:`specforge_tpu_torch.ops.peagle_attention_cuda.cod_flash_attention`,
  its plain version on CPU tensors); ``"dense"`` is the dense masked path
  over the [B, T, T] mask. The JAX package's TPU crossover between the two
  is TPU tuning and not ported.

Parameters are fp32; every matrix product runs in ``dtype``; RMSNorm
computes its statistics in fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    Eagle3MLP,
    Linear,
    RMSNorm,
)
from specforge_tpu_torch.ops.peagle_attention_cuda import (
    NEG_INF,
    CODTiles,
    cod_flash_attention,
)
from specforge_tpu_torch.ops.rope import RopeSpec, apply_rope, rope_cos_sin
from specforge_tpu_torch.utils import DeviceLike, resolve_device

ATTENTION_BACKENDS = ("auto", "pallas", "dense")


@dataclass(frozen=True)
class PEagleConfig(Eagle3Config):
    norm_before_residual: bool = False


def cod_capacities(
    seq_length: int,
    num_depths: int,
    down_sample_ratio: float,
    down_sample_ratio_min: float,
) -> Tuple[int, ...]:
    """Per-depth COD sample capacities (static given the sampler config):
    depth 0 keeps every position; depth d keeps ``ceil(S * ratio^d)``,
    bounded below by ``ratio_min``."""
    caps = [seq_length]
    for d in range(1, num_depths):
        ratio = max(down_sample_ratio ** d, down_sample_ratio_min)
        caps.append(int(math.ceil(seq_length * ratio)))
    return tuple(caps)


class PEagleAttention(nn.Module):
    """Attention with an arbitrary input width under the COD mask: the
    dense backend reads the [B, T, T] ``allow_mask``; the kernel backend
    reads ``tiles`` (the properties and the skip table of the sample)."""

    def __init__(self, config: PEagleConfig, input_size: int, dtype,
                 attention_backend: str, device=None):
        super().__init__()
        if attention_backend not in ATTENTION_BACKENDS:
            raise ValueError(
                f"attention_backend {attention_backend!r} not in "
                f"{ATTENTION_BACKENDS}"
            )
        self.config = config
        self.attention_backend = attention_backend
        d = config.resolved_head_dim
        h, kvh = config.num_attention_heads, config.num_key_value_heads
        self.qkv_proj = Linear(input_size, (h + 2 * kvh) * d, dtype, device)
        self.o_proj = Linear(h * d, config.hidden_size, dtype, device)

    def forward(self, x, allow_mask, cos, sin,
                tiles: Optional[CODTiles] = None) -> torch.Tensor:
        cfg = self.config
        b, t, _ = x.shape
        d = cfg.resolved_head_dim
        h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
        g = h // kvh
        qc, kc = h * d, kvh * d
        qkv = self.qkv_proj(x)
        q = qkv[..., :qc].view(b, t, h, d).transpose(1, 2)
        k = qkv[..., qc:qc + kc].view(b, t, kvh, d).transpose(1, 2)
        v = qkv[..., qc + kc:].view(b, t, kvh, d).transpose(1, 2)
        q, k = apply_rope(q, k, cos, sin)
        if self.attention_backend != "dense":
            if tiles is None:
                raise ValueError("the COD kernel backend needs the sample's "
                                 "tiles (cod_tiles)")
            return self.o_proj(cod_flash_attention(q, k, v, tiles=tiles))
        # the dense path: fp32 scores of the working-dtype q and k, masked
        # softmax, probabilities cast back, as the JAX dense path does
        qg = q.reshape(b, kvh, g, t, d)
        w = torch.einsum("bkgsd,bktd->bkgst", qg.float(), k.float()) / (
            d ** 0.5)
        w = torch.where(allow_mask[:, None, None], w,
                        torch.full_like(w, NEG_INF))
        p = torch.softmax(w, dim=-1).to(x.dtype)
        out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(p.dtype))
        out = out.reshape(b, h, t, d).transpose(1, 2).reshape(b, t, h * d)
        return self.o_proj(out)


class PEagleFirstLayer(nn.Module):
    """Layer 0 over the 2*hidden concat: separate norms for the embedding
    half and the hidden half; the residual is the hidden half (normed when
    ``norm_before_residual``)."""

    def __init__(self, config: PEagleConfig, dtype, attention_backend: str,
                 device=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.config = config
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device)
        self.hidden_norm = RMSNorm(config.hidden_size, eps, device)
        self.self_attn = PEagleAttention(config, 2 * config.hidden_size,
                                         dtype, attention_backend, device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps, device)
        self.mlp = Eagle3MLP(config, dtype, device)

    def forward(self, x2h, allow_mask, cos, sin, tiles=None):
        mid = x2h.shape[-1] // 2
        embeds, hidden = x2h[..., :mid], x2h[..., mid:]
        residual = hidden
        embeds = self.input_layernorm(embeds)
        hidden = self.hidden_norm(hidden)
        if self.config.norm_before_residual:
            residual = hidden
        x = torch.cat([embeds, hidden], dim=-1)
        x = self.self_attn(x, allow_mask, cos, sin, tiles)
        hidden = residual + x
        residual = hidden
        return residual + self.mlp(self.post_attention_layernorm(hidden))


class PEagleStandardLayer(nn.Module):
    def __init__(self, config: PEagleConfig, dtype, attention_backend: str,
                 device=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device)
        self.self_attn = PEagleAttention(config, config.hidden_size, dtype,
                                         attention_backend, device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps, device)
        self.mlp = Eagle3MLP(config, dtype, device)

    def forward(self, x, allow_mask, cos, sin, tiles=None):
        residual = x
        x = residual + self.self_attn(self.input_layernorm(x), allow_mask,
                                      cos, sin, tiles)
        return x + self.mlp(self.post_attention_layernorm(x))


class PEagleDraftModel(nn.Module):
    """Multi-layer parallel draft that trains its own embeddings and
    ``mask_hidden``. ``device`` defaults to CUDA (and raises without it);
    weights are drawn from a generator on that device seeded with ``seed``.
    The layers are ``layers_0`` … ``layers_{L-1}``, the JAX names."""

    def __init__(
        self,
        config: PEagleConfig,
        dtype: torch.dtype = torch.bfloat16,
        attention_backend: str = "auto",
        device: DeviceLike = None,
        seed: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        self.attention_backend = attention_backend
        self.num_layers = config.num_hidden_layers
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                         device=device)
        fc_in = 3 * config.resolved_target_hidden_size
        self.fc = Linear(fc_in, config.hidden_size, dtype, device)
        self.mask_hidden = nn.Parameter(torch.empty(1, 1, fc_in, device=device))
        self.layers_0 = PEagleFirstLayer(config, dtype, attention_backend,
                                         device)
        for i in range(1, config.num_hidden_layers):
            setattr(self, f"layers_{i}", PEagleStandardLayer(
                config, dtype, attention_backend, device))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)
        self.lm_head = Linear(config.hidden_size, config.draft_vocab_size,
                              dtype, device)
        self.rope_spec = RopeSpec.from_config(config)
        # identity vocab maps until a real mapping is loaded
        self.register_buffer(
            "t2d", torch.ones(config.vocab_size, dtype=torch.bool, device=device)
        )
        self.register_buffer(
            "d2t",
            torch.zeros(config.draft_vocab_size, dtype=torch.int64,
                        device=device),
        )
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init: unit-normal embedding and ``mask_hidden``,
        fan-in-scaled normal projections, unit norm weights."""
        self.embed_tokens.weight.normal_(0.0, 1.0, generator=generator)
        self.mask_hidden.normal_(0.0, 1.0, generator=generator)
        for module in self.modules():
            if isinstance(module, Linear):
                fan_in = module.weight.shape[1]
                module.weight.normal_(0.0, fan_in ** -0.5, generator=generator)

    @property
    def layers(self):
        return [getattr(self, f"layers_{i}") for i in range(self.num_layers)]

    def set_vocab_maps(self, t2d, d2t) -> None:
        self.t2d.copy_(torch.as_tensor(t2d, dtype=torch.bool))
        self.d2t.copy_(torch.as_tensor(d2t, dtype=torch.int64))

    def embed_input_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Gather the fp32 rows first, then cast: casting the [V, H] table
        first would write all of it to produce a few thousand rows."""
        return torch.nn.functional.embedding(
            input_ids, self.embed_tokens.weight).to(self.dtype)

    def project_hidden_states(self, hidden_3h: torch.Tensor) -> torch.Tensor:
        return self.fc(hidden_3h)

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.norm(hidden))

    def backbone(self, input_embeds, hidden_states, allow_mask, position_ids,
                 tiles: Optional[CODTiles] = None) -> torch.Tensor:
        """input_embeds/hidden_states [B, T, h]; allow_mask [B, T, T];
        ``tiles`` the sample's kernel inputs, built once per forward and
        shared by every layer."""
        x = torch.cat([input_embeds.to(self.dtype),
                       hidden_states.to(self.dtype)], dim=-1)
        cos, sin = rope_cos_sin(self.rope_spec, position_ids,
                                int(self.config.max_position_embeddings),
                                dtype=x.dtype)
        for layer in self.layers:
            x = layer(x, allow_mask, cos, sin, tiles)
        return x
