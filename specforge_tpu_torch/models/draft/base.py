"""Draft-model configuration base.

Counterpart of ``specforge_tpu/models/draft/base.py``: configs mirror the
HF-style JSON files under ``configs/``, so the same files drive both
packages.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class DraftModelConfig:
    """Common HF-style fields; per-architecture configs extend this."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_attention_heads: int
    num_key_value_heads: int
    num_hidden_layers: int = 1
    head_dim: Optional[int] = None
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 32768
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    pad_token_id: Optional[int] = None
    bos_token_id: Optional[int] = None
    eos_token_id: Optional[int] = None
    tie_word_embeddings: bool = False
    architectures: Tuple[str, ...] = ()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @classmethod
    def field_names(cls) -> set:
        return {f.name for f in dataclasses.fields(cls)}

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "DraftModelConfig":
        known = cls.field_names()
        kwargs = {k: v for k, v in obj.items() if k in known}
        if kwargs.get("architectures") is not None:
            kwargs["architectures"] = tuple(kwargs["architectures"])
        return cls(**kwargs)

    @classmethod
    def from_file(cls, path) -> "DraftModelConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["architectures"] = list(out["architectures"])
        return out
