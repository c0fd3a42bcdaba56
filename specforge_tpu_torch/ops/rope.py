"""Rotary position embeddings.

Counterpart of ``specforge_tpu/ops/rope.py``. :class:`RopeSpec` parses the
HF-style rope fields of every config; this slice computes the ``default``
type (inv_freq = base^(-2i/d)), which is what Qwen3-8B uses. The scaled types
(linear, dynamic, llama3, yarn, mrope) raise until they are ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class RopeSpec:
    head_dim: int
    base: float = 10000.0
    max_position_embeddings: int = 2048
    scaling_type: str = "default"  # default|linear|dynamic|llama3|yarn|mrope
    scaling_factor: Optional[float] = None
    # llama3
    low_freq_factor: Optional[float] = None
    high_freq_factor: Optional[float] = None
    original_max_position_embeddings: Optional[int] = None
    # yarn
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0
    # mrope
    mrope_section: Tuple[int, ...] = ()

    @classmethod
    def from_config(cls, config) -> "RopeSpec":
        """Build from a draft-model config carrying HF-style rope fields."""
        rope_scaling = getattr(config, "rope_scaling", None)
        head_dim = getattr(config, "head_dim", None) or (
            config.hidden_size // config.num_attention_heads
        )
        base = float(getattr(config, "rope_theta", 10000.0))
        max_pos = int(getattr(config, "max_position_embeddings", 2048))
        if not rope_scaling:
            return cls(head_dim=head_dim, base=base, max_position_embeddings=max_pos)

        def get(key, default=None):
            if isinstance(rope_scaling, dict):
                return rope_scaling.get(key, default)
            return getattr(rope_scaling, key, default)

        return cls(
            head_dim=head_dim,
            base=base,
            max_position_embeddings=max_pos,
            scaling_type=get("rope_type", get("type", "default")),
            scaling_factor=get("factor"),
            low_freq_factor=get("low_freq_factor"),
            high_freq_factor=get("high_freq_factor"),
            original_max_position_embeddings=get(
                "original_max_position_embeddings"
            ),
            beta_fast=get("beta_fast", 32.0) or 32.0,
            beta_slow=get("beta_slow", 1.0) or 1.0,
            mscale=get("mscale", 1.0) or 1.0,
            mscale_all_dim=get("mscale_all_dim", 0.0) or 0.0,
            mrope_section=tuple(get("mrope_section", ()) or ()),
        )


def inv_freq_and_scale(spec: RopeSpec, seq_len: int) -> Tuple[np.ndarray, float]:
    """Inverse frequencies (float32, computed in float64) and cos/sin scale."""
    if spec.scaling_type != "default":
        raise NotImplementedError(
            f"RoPE type {spec.scaling_type!r} is not ported yet (only 'default')"
        )
    dim = spec.head_dim
    inv_freq = 1.0 / (
        spec.base ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    )
    return inv_freq.astype(np.float32), 1.0


def rope_cos_sin(
    spec: RopeSpec,
    position_ids: torch.Tensor,
    seq_len: int,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, S, head_dim] for [B, S] positions; frequencies are
    computed in fp32, then cast to ``dtype``."""
    inv_freq, attn_scale = inv_freq_and_scale(spec, seq_len)
    inv = torch.from_numpy(inv_freq).to(position_ids.device)
    freqs = position_ids.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = (torch.cos(emb) * attn_scale).to(dtype)
    sin = (torch.sin(emb) * attn_scale).to(dtype)
    return cos, sin


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply rotary embedding. q/k: [B, H, S, D]; cos/sin: [B, S, D]."""
    cos = cos[:, None]
    sin = sin[:, None]
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
