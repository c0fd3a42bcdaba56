"""Frozen dense target transformer for offline feature capture.

Counterpart of ``specforge_tpu/models/target/transformer.py`` for the
dense llama, qwen2 and qwen3 families: a functional decoder over a flat
``{hf_key: tensor}`` dict read straight from the HF safetensors shards (by
the port's own reader), run as a prefill to capture the EAGLE3 / DFlash
training features. Compute is in the weights' dtype (bf16) with fp32 norm
statistics, fp32 attention logits and an fp32 softmax; a caller may ask for
another compute dtype (fp32), and each weight is then cast as it is used.
The attention is plain torch (scores, softmax, product), as the JAX
package leaves it to XLA: no kernel is written for it until an H100
profile calls for one (``ROADMAP.md`` Queue 2 item 6).

Capture convention: ``hidden_states[0]`` is the embedding output and
``hidden_states[i+1]`` the output of layer ``i``, so capture layer ``i``
(``-1`` for the embedding) is the residual stream after layer ``i``.

Every other family of the JAX package (MoE, MLA, sliding windows, the VL
towers' mrope, ...) is refused by name: ``ROADMAP.md`` Queue 1 item 7c.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from specforge_tpu_torch.ops.rope import RopeSpec, apply_rope, rope_cos_sin
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    read_safetensors_keys,
    read_safetensors_tensors,
)
from specforge_tpu_torch.utils import DeviceLike, resolve_device

#: the families the port's capture forward runs
SUPPORTED_MODEL_TYPES = ("llama", "qwen2", "qwen3")
#: large-negative additive bias (finite: a fully masked row stays finite)
NEG_INF = -1e38
_LATER = ("ROADMAP.md Queue 1 item 7c (the other target families) brings "
          "it")


@dataclass(frozen=True)
class TargetConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    qk_norm: bool = False          # qwen3-style per-head q/k norms
    model_type: str = "llama"
    hidden_act: str = "silu"
    # muP-pretrained targets: logits = lm_head(h) / multiplier; the loader
    # folds 1/multiplier into lm_head once, so the captured last hidden
    # stays the canonical post-norm h
    logits_mup_width_multiplier: Optional[float] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @classmethod
    def from_file(cls, path: str) -> "TargetConfig":
        with open(os.path.join(path, "config.json")) as f:
            raw = json.load(f)
        raw = raw.get("text_config", raw)
        model_type = raw.get("model_type", "llama")
        if model_type not in SUPPORTED_MODEL_TYPES:
            raise ValueError(
                f"target architecture {model_type!r} is not supported by the "
                f"port's capture forward (dense {', '.join(SUPPORTED_MODEL_TYPES)}"
                f" only): {_LATER}"
            )
        return cls(
            vocab_size=raw["vocab_size"],
            hidden_size=raw["hidden_size"],
            intermediate_size=raw["intermediate_size"],
            num_hidden_layers=raw["num_hidden_layers"],
            num_attention_heads=raw["num_attention_heads"],
            num_key_value_heads=raw.get(
                "num_key_value_heads", raw["num_attention_heads"]
            ),
            head_dim=raw.get("head_dim"),
            rms_norm_eps=raw.get("rms_norm_eps", 1e-6),
            rope_theta=raw.get("rope_theta", 10000.0),
            rope_scaling=raw.get("rope_scaling"),
            max_position_embeddings=raw.get("max_position_embeddings", 32768),
            tie_word_embeddings=raw.get("tie_word_embeddings", False),
            qk_norm=model_type == "qwen3",
            model_type=model_type,
            hidden_act=raw.get("hidden_act", "silu"),
            logits_mup_width_multiplier=raw.get(
                "logits_mup_width_multiplier"
            ),
        )


def load_target_params(
    path: str, config: TargetConfig, dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Every decoder weight of the HF safetensors checkpoint at ``path``
    (one ``model.safetensors`` or shards named by a ``*.index.json``), on
    CUDA unless the caller names another device; floating tensors in
    ``dtype``."""
    device = resolve_device(device)
    index_files = glob.glob(os.path.join(path, "*.index.json"))
    key_to_shard: Dict[str, str] = {}
    if index_files:
        with open(index_files[0]) as f:
            key_to_shard = json.load(f)["weight_map"]
    else:
        for key in read_safetensors_keys(os.path.join(path,
                                                      "model.safetensors")):
            key_to_shard[key] = "model.safetensors"

    wanted_prefixes = ("model.", "lm_head.")
    by_shard: Dict[str, List[str]] = {}
    for key, shard in key_to_shard.items():
        if key.startswith(wanted_prefixes):
            by_shard.setdefault(shard, []).append(key)

    params: Dict[str, torch.Tensor] = {}
    for shard, keys in sorted(by_shard.items()):
        tensors = read_safetensors_tensors(os.path.join(path, shard), keys)
        for key, value in tensors.items():
            value = value.to(device)
            params[key] = (value.to(dtype) if value.is_floating_point()
                           else value)
        del tensors
    if config.tie_word_embeddings and "lm_head.weight" not in params:
        params["lm_head.weight"] = params["model.embed_tokens.weight"]
    mup = config.logits_mup_width_multiplier
    if mup:
        if config.tie_word_embeddings:
            raise ValueError(
                "cannot fold logits_mup_width_multiplier into a tied "
                "embedding/lm_head (the fold would corrupt the embedding)"
            )
        # the JAX package divides by the multiplier rounded to the head's
        # dtype (a weakly typed scalar); so does the port
        head = params["lm_head.weight"]
        params["lm_head.weight"] = head / torch.tensor(
            float(mup), dtype=head.dtype, device=head.device)
    return params


def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    return weight.to(dtype) * x32.to(dtype)


def _act(name: str):
    return {"silu": F.silu, "gelu": F.gelu,
            "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh")}[
        name]


def make_causal_bias(attention_mask: Optional[torch.Tensor], batch: int,
                     seq: int, device) -> torch.Tensor:
    """Additive fp32 [B, 1, S, S] bias: causality and key padding
    (``attention_mask`` [B, S], 1 = real token)."""
    row = torch.arange(seq, device=device)[:, None]
    col = torch.arange(seq, device=device)[None, :]
    causal = torch.where(col <= row, 0.0, NEG_INF).to(torch.float32)
    bias = causal[None, None].expand(batch, 1, seq, seq)
    if attention_mask is not None:
        key_ok = attention_mask.to(device=device, dtype=torch.bool)
        bias = torch.where(key_ok[:, None, None, :], bias,
                           torch.tensor(NEG_INF, device=device))
    return bias


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Grouped-query softmax attention, plain: q [B, H, S, D], k/v
    [B, KVH, S, D], bias [B, 1, S, S] → [B, S, H·D]. The scores are the
    fp32 products of the inputs (bf16 products are exact in fp32), the
    softmax fp32, the probabilities cast to v's dtype for the product."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, kvh, h // kvh, s, d)
    w = torch.matmul(qg.float(), k.float()[:, :, None].transpose(-1, -2))
    w.mul_(scale).add_(bias[:, :, None])
    p = torch.softmax(w, dim=-1).to(v.dtype)
    del w
    attn = torch.matmul(p, v[:, :, None])
    return attn.reshape(b, h, s, d).transpose(1, 2).reshape(b, s, h * d)


def _linear(params, key: str, x: torch.Tensor) -> torch.Tensor:
    out = torch.matmul(x, params[f"{key}.weight"].to(x.dtype).T)
    bias = params.get(f"{key}.bias")
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def _std_attention(params, cfg: TargetConfig, prefix: str, y: torch.Tensor,
                   bias: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                   ) -> torch.Tensor:
    """GQA attention of the dense families: separate q/k/v projections
    (biased for qwen2), the qwen3 per-head q/k RMSNorm, RoPE."""
    b, s, _ = y.shape
    d = cfg.resolved_head_dim
    h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    ap = f"{prefix}.self_attn"
    q = _linear(params, f"{ap}.q_proj", y).reshape(b, s, h, d)
    k = _linear(params, f"{ap}.k_proj", y).reshape(b, s, kvh, d)
    v = _linear(params, f"{ap}.v_proj", y).reshape(b, s, kvh, d)
    if cfg.qk_norm:
        q = _rms(q, params[f"{ap}.q_norm.weight"], cfg.rms_norm_eps)
        k = _rms(k, params[f"{ap}.k_norm.weight"], cfg.rms_norm_eps)
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    q, k = apply_rope(q, k, cos, sin)
    attn = _attend(q, k, v, bias, d ** -0.5)
    return _linear(params, f"{ap}.o_proj", attn)


def _dense_mlp(params, cfg: TargetConfig, prefix: str, y: torch.Tensor
               ) -> torch.Tensor:
    act = _act(cfg.hidden_act)
    gate = _linear(params, f"{prefix}.gate_proj", y)
    up = _linear(params, f"{prefix}.up_proj", y)
    return _linear(params, f"{prefix}.down_proj", act(gate) * up)


@torch.no_grad()
def target_capture_forward(
    params: Dict[str, torch.Tensor],
    config: TargetConfig,
    input_ids: torch.Tensor,                 # [B, S]
    attention_mask: Optional[torch.Tensor],  # [B, S]
    capture_layers: Sequence[int],
    compute_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward → (aux concat [B, S, L·H], post-norm last hidden
    [B, S, H]), on the device of ``params``, at positions 0..S-1 (the
    capture inputs are right-padded). ``compute_dtype``: the activations'
    dtype (default the embedding's); each weight is cast to it as it is
    used."""
    cfg = config
    embed = params["model.embed_tokens.weight"]
    device = embed.device
    input_ids = input_ids.to(device)
    b, s = input_ids.shape
    capture_set = set(int(c) for c in capture_layers)
    bad = sorted(c for c in capture_set
                 if not -1 <= c < cfg.num_hidden_layers)
    if bad:
        raise ValueError(
            f"capture layers {bad} out of range "
            f"(-1..{cfg.num_hidden_layers - 1})"
        )
    x = embed[input_ids].to(compute_dtype or embed.dtype)
    bias = make_causal_bias(attention_mask, b, s, device)
    position_ids = torch.arange(s, device=device)[None].expand(b, s)
    spec = RopeSpec.from_config(cfg)
    if spec.head_dim != cfg.resolved_head_dim:
        spec = dataclasses.replace(spec, head_dim=cfg.resolved_head_dim)
    cos, sin = rope_cos_sin(spec, position_ids, s, dtype=x.dtype)

    captured: Dict[int, torch.Tensor] = {}
    if -1 in capture_set:
        captured[-1] = x
    for i in range(cfg.num_hidden_layers):
        prefix = f"model.layers.{i}"
        residual = x
        y = _rms(x, params[f"{prefix}.input_layernorm.weight"],
                 cfg.rms_norm_eps)
        x = residual + _std_attention(params, cfg, prefix, y, bias, cos, sin)
        residual = x
        y = _rms(x, params[f"{prefix}.post_attention_layernorm.weight"],
                 cfg.rms_norm_eps)
        x = residual + _dense_mlp(params, cfg, f"{prefix}.mlp", y)
        if i in capture_set:
            captured[i] = x
    last_hidden = _rms(x, params["model.norm.weight"], cfg.rms_norm_eps)
    aux = torch.cat([captured[int(i)] for i in capture_layers], dim=-1)
    return aux, last_hidden
