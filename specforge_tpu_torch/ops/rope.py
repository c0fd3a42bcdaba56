"""Rotary position embeddings.

Counterpart of ``specforge_tpu/ops/rope.py``. :class:`RopeSpec` parses the
HF-style rope fields of every config, and the tables follow the same
variants (frequencies in float64 numpy, then fp32):

- ``default``  — inv_freq = base^(-2i/d).
- ``linear``   — positions divided by ``factor``.
- ``dynamic``  — NTK-aware base rescale when ``seq_len`` exceeds
                 ``max_position_embeddings``.
- ``llama3``   — wavelength-banded frequency scaling.
- ``yarn``     — interpolation/extrapolation ramp, and an mscale on cos/sin.
- ``mrope``    — multimodal 3-axis rope: [3, B, S] positions, the head dim's
                 sections each taking the table of one axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

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


def _base_inv_freq(head_dim: int, base: float) -> np.ndarray:
    return 1.0 / (base ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def _yarn_find_correction_dim(num_rotations, dim, base, max_pos) -> float:
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (
        2 * math.log(base)
    )


def _yarn_ramp(low: float, high: float, dim: int) -> np.ndarray:
    if low == high:
        high += 0.001
    linear = (np.arange(dim, dtype=np.float32) - low) / (high - low)
    return np.clip(linear, 0.0, 1.0)


def _yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _llama3_inv_freq(spec: RopeSpec, inv_freq: np.ndarray) -> np.ndarray:
    factor = spec.scaling_factor or 1.0
    orig_max = spec.original_max_position_embeddings
    low_f, high_f = spec.low_freq_factor, spec.high_freq_factor
    if None in (orig_max, low_f, high_f):
        return inv_freq
    low_freq_wavelen = orig_max / low_f
    high_freq_wavelen = orig_max / high_f
    wave_len = 2 * math.pi / inv_freq
    if low_f != high_f:
        smooth = (orig_max / wave_len - low_f) / (high_f - low_f)
    else:
        smooth = np.zeros_like(wave_len)
    return np.where(
        wave_len < high_freq_wavelen,
        inv_freq,
        np.where(
            wave_len > low_freq_wavelen,
            inv_freq / factor,
            (1 - smooth) * inv_freq / factor + smooth * inv_freq,
        ),
    )


def _yarn_inv_freq_and_scale(spec: RopeSpec) -> Tuple[np.ndarray, float]:
    dim = spec.head_dim
    factor = spec.scaling_factor or 1.0
    orig_max = spec.original_max_position_embeddings or 4096
    freq_extra = _base_inv_freq(dim, spec.base)
    freq_inter = freq_extra / factor
    low = max(
        math.floor(_yarn_find_correction_dim(spec.beta_fast, dim, spec.base, orig_max)),
        0,
    )
    high = min(
        math.ceil(_yarn_find_correction_dim(spec.beta_slow, dim, spec.base, orig_max)),
        dim - 1,
    )
    inv_freq_mask = 1.0 - _yarn_ramp(low, high, dim // 2)
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    attn_scale = float(
        _yarn_get_mscale(factor, spec.mscale)
        / _yarn_get_mscale(factor, spec.mscale_all_dim)
    )
    return inv_freq, attn_scale


def inv_freq_and_scale(spec: RopeSpec, seq_len: int) -> Tuple[np.ndarray, float]:
    """Inverse frequencies (float32, computed in float64) and the cos/sin
    scale, for tables that cover ``seq_len`` positions."""
    dim = spec.head_dim
    inv_freq = _base_inv_freq(dim, spec.base)
    attn_scale = 1.0
    kind = spec.scaling_type
    if kind in ("default", "linear", "mrope"):
        pass
    elif kind == "dynamic":
        factor = spec.scaling_factor or 1.0
        if seq_len > spec.max_position_embeddings:
            base = spec.base * (
                (factor * seq_len / spec.max_position_embeddings) - (factor - 1)
            ) ** (dim / (dim - 2))
            inv_freq = _base_inv_freq(dim, base)
    elif kind == "llama3":
        inv_freq = _llama3_inv_freq(spec, inv_freq)
    elif kind == "yarn":
        inv_freq, attn_scale = _yarn_inv_freq_and_scale(spec)
    else:
        raise ValueError(f"Unknown RoPE scaling type {kind}")
    return inv_freq.astype(np.float32), attn_scale


def rope_cos_sin(
    spec: RopeSpec,
    position_ids: torch.Tensor,
    seq_len: int,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, S, head_dim] for [B, S] positions ([3, B, S,
    head_dim] for mrope's [3, B, S]); frequencies are computed in fp32, then
    cast to ``dtype``."""
    inv_freq, attn_scale = inv_freq_and_scale(spec, seq_len)
    inv = torch.from_numpy(inv_freq).to(position_ids.device)
    pos = position_ids.float()
    if spec.scaling_type == "linear" and spec.scaling_factor:
        pos = pos / spec.scaling_factor
    freqs = pos[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = (torch.cos(emb) * attn_scale).to(dtype)
    sin = (torch.sin(emb) * attn_scale).to(dtype)
    return cos, sin


def rope_table(spec: RopeSpec, max_len: int, dtype: torch.dtype, device,
               seq_len: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [max_len, D] for positions 0 .. max_len - 1, the rows
    ``rope_cos_sin`` gives them at ``seq_len`` (default ``max_len``): made
    once for a decoder, so that a step captured as a CUDA graph indexes
    them and reads no host memory."""
    positions = torch.arange(max_len, device=device)[None]
    cos, sin = rope_cos_sin(spec, positions, seq_len or max_len, dtype=dtype)
    return cos[0], sin[0]


def rope_at(spec: RopeSpec, positions: torch.Tensor, seq_len: int,
            dtype: torch.dtype, table=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [B, T, D] at [B, T] ``positions``: rows of ``table``
    (``rope_table``'s, positions clamped into it) or computed."""
    if table is None:
        return rope_cos_sin(spec, positions, seq_len, dtype=dtype)
    cos, sin = table
    idx = positions.clamp(0, cos.shape[0] - 1)
    return cos[idx], sin[idx]


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


def _mrope_select(t: torch.Tensor, mrope_section: Sequence[int]) -> torch.Tensor:
    """[3, B, S, D] -> [B, 1, S, D]: chunk i of the doubled section list
    takes its table from axis ``i % 3``."""
    chunks = torch.split(t, list(mrope_section) * 2, dim=-1)
    return torch.cat([c[i % 3] for i, c in enumerate(chunks)], dim=-1)[:, None]


def apply_multimodal_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mrope_section: Sequence[int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-axis multimodal rope. q/k: [B, H, S, D]; cos/sin: [3, B, S, D]."""
    cos = _mrope_select(cos, mrope_section)
    sin = _mrope_select(sin, mrope_section)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin
