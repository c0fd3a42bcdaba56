"""Frozen target transformer for offline feature capture.

Counterpart of ``specforge_tpu/models/target/transformer.py``: a
functional decoder over a flat ``{hf_key: tensor}`` dict read straight from
the HF safetensors shards (by the port's own reader), run as a prefill to
capture the EAGLE3 / DFlash training features. It covers every family the
JAX package captures from: the dense llama, qwen2, qwen3 and phi3 (fused
``qkv_proj``/``gate_up_proj``) families; gemma3 (sandwich norms, the
zero-centred RMSNorm, sliding layers with their own rope base, the logit
softcap); gpt-oss (learned attention sinks, sliding layers, the clamped
SwiGLU experts); the MLA families deepseek_v2, deepseek_v3, kimi_k2 and
longcat_flash (its dual sublayers and zero experts); glm4_moe (partial
rotary); llama4 (NoPE layers with temperature tuning, chunked attention,
input-scaled experts); qwen3_moe; qwen3_next (gated DeltaNet layers, the
gated attention output and shared expert); and the Qwen2/2.5-VL text
towers (3-axis mrope, ``inputs_embeds`` as the multimodal seam).

Compute is in the weights' dtype (bf16) with fp32 norm statistics, fp32
attention logits and an fp32 softmax; a caller may ask for another
compute dtype (fp32), and each weight is then cast as it is used. What the
JAX package leaves to XLA stays plain torch: the attention (scores,
softmax, product) and the expert products, which run as one
``torch.matmul`` per expert over its contiguous group of sorted
assignments (``ROADMAP.md`` Queue 2 item 6 holds a grouped GEMM for when
an H100 profile calls for one). The experts' outputs are combined without
atomics: every token has exactly k assignments, so the sorted rows are put
back in token order by a gather and summed over k in a fixed order, and a
capture repeats bit for bit.

Capture convention: ``hidden_states[0]`` is the embedding output and
``hidden_states[i+1]`` the output of layer ``i``, so capture layer ``i``
(``-1`` for the embedding) is the residual stream after layer ``i``.

On a capture mesh (``parallel/mesh.py``, one process per rank) the
parameters are a :class:`~.sharding.ShardedParams`: each rank holds its
slice of every sharded leaf, the forward gathers one layer's leaves at a
time and the embedding's rows the batch uses, and every rank computes the
whole batch, so its features are one process's bit for bit. With
``moe_impl="ep"`` each rank keeps its share of the experts and computes
only their rows (``_moe_ep``): the capacity factor, overflow count and
padding rule of the JAX package's ``_moe_mlp_ep``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from specforge_tpu_torch.models.target.sharding import (
    ShardedParams,
    ep_capacity,
    ep_mix,
    load_sharded,
)
from specforge_tpu_torch.ops.rope import (
    RopeSpec,
    apply_multimodal_rope,
    apply_rope,
    rope_cos_sin,
)
from specforge_tpu_torch.parallel.mesh import Mesh
from specforge_tpu_torch.parallel.usp import all_reduce_sum
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    read_safetensors_keys,
    read_safetensors_tensors,
)
from specforge_tpu_torch.utils import DeviceLike, resolve_device

#: large-negative additive bias (finite: a fully masked row stays finite)
NEG_INF = -1e38
#: the families the capture forward cannot run, with the JAX package's
#: reasons (a refusal at composition time beats a wrong forward)
UNSUPPORTED_MODEL_TYPES = {
    "bailing_moe": "not present in the installed transformers; no parity "
                   "oracle available",
}
#: how the MoE layers combine their experts: ``gathered`` (sorted
#: assignments, one product per expert over its group), ``dense`` (every
#: expert over every token, weighted by its routing weight: the reference)
#: or ``ep`` (each rank of a capture mesh its own experts' rows)
MOE_IMPLS = ("gathered", "dense", "ep")
#: the MoE variants expert parallelism takes (``transformer.py:1719-1723``
#: of the JAX package)
EP_VARIANTS = ("qwen", "deepseek", "gptoss")
_VL_TEXT = ("qwen2_5_vl_text", "qwen2_vl_text")


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
    # MoE (qwen3_moe family)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    norm_topk_prob: bool = False
    moe_intermediate_size: Optional[int] = None
    decoder_sparse_step: int = 1
    mlp_only_layers: Tuple[int, ...] = ()
    # attention variant: "standard" | "mla" (deepseek v2/v3, kimi, longcat)
    attn_variant: str = "standard"
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    rope_interleave: bool = False
    # v3 multiplies the softmax scale by yarn mscale²; v2 does not
    mla_logit_mscale: bool = False
    # per-layer attention kinds: "full_attention" | "sliding_attention" |
    # "chunked_attention" | "linear_attention"; empty = all full
    layer_types: Tuple[str, ...] = ()
    sliding_window: Optional[int] = None
    rope_local_base_freq: Optional[float] = None   # gemma3 sliding-layer theta
    query_pre_attn_scalar: Optional[float] = None  # gemma3 attention scale
    attn_logit_softcapping: Optional[float] = None
    norm_style: str = "standard"   # "gemma" = fp32 x_norm * (1 + w)
    sandwich_norms: bool = False   # gemma3 post-attention/post-mlp norms
    embed_scale: Optional[float] = None            # gemma3 sqrt(hidden)
    attention_sinks: bool = False  # gpt-oss learned per-head sink logits
    partial_rotary_factor: float = 1.0             # glm4_moe 0.5
    # MoE variant: "qwen" | "deepseek" | "gptoss" | "llama4" | "longcat"
    moe_variant: str = "qwen"
    n_shared_experts: int = 0
    routed_scaling_factor: float = 1.0
    scoring_func: str = "softmax"   # deepseek v2 softmax, v3 sigmoid
    topk_method: str = "greedy"     # greedy|group_limited_greedy|noaux_tc
    n_group: int = 1
    topk_group: int = 1
    first_k_dense_replace: int = 0
    moe_alpha: float = 1.702        # gpt-oss clamp-swiglu
    moe_limit: float = 7.0
    # llama4: rope skipped on listed layers (value 0), chunked attention on
    # rope layers, L2 qk norm, nope-layer temperature tuning, input-scaled
    # fused experts with a shared expert, dense layers of their own width
    no_rope_layers: Tuple[int, ...] = ()
    attention_chunk_size: Optional[int] = None
    qk_l2_norm: bool = False
    attn_temperature_tuning: bool = False
    attn_scale: float = 0.1
    floor_scale: float = 8192.0
    moe_layers: Tuple[int, ...] = ()
    intermediate_size_mlp: Optional[int] = None
    # qwen3_next: gated DeltaNet layers beside gated full attention
    attn_output_gate: bool = False   # q_proj carries a sigmoid output gate
    shared_expert_gated: bool = False  # sigmoid-gated always-on shared MLP
    linear_num_value_heads: int = 0
    linear_num_key_heads: int = 0
    linear_key_head_dim: int = 0
    linear_value_head_dim: int = 0
    linear_conv_kernel_dim: int = 4
    # longcat_flash: logical layers of two MLA + dense-MLP sublayers and a
    # shortcut MoE with zero (identity) experts; LoRA rescaling inside MLA
    dual_sublayer: bool = False
    zero_expert_num: int = 0
    mla_lora_scaling: bool = False
    router_bias: bool = False
    # muP-pretrained targets: logits = lm_head(h) / multiplier; the loader
    # folds 1/multiplier into lm_head once, so the captured last hidden
    # stays the canonical post-norm h
    logits_mup_width_multiplier: Optional[float] = None

    @property
    def mrope_section(self) -> Tuple[int, ...]:
        """Multimodal rope channel sections (qwen2/2.5-vl text towers)."""
        if not self.rope_scaling:
            return ()
        return tuple(self.rope_scaling.get("mrope_section") or ())

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def layer_kind(self, layer_idx: int) -> str:
        if not self.layer_types:
            return "full_attention"
        return self.layer_types[layer_idx]

    def is_moe_layer(self, layer_idx: int) -> bool:
        """Per-family MoE placement: deepseek-style after
        ``first_k_dense_replace``, llama4 an explicit list, the others the
        sparse-step rule less ``mlp_only_layers``."""
        if self.num_experts <= 0:
            return False
        if self.moe_variant == "deepseek":
            return layer_idx >= self.first_k_dense_replace
        if self.moe_variant == "llama4":
            return layer_idx in self.moe_layers
        return (
            layer_idx not in self.mlp_only_layers
            and (layer_idx + 1) % max(self.decoder_sparse_step, 1) == 0
        )

    @classmethod
    def from_file(cls, path: str) -> "TargetConfig":
        with open(os.path.join(path, "config.json")) as f:
            raw = json.load(f)
        raw = raw.get("text_config", raw)
        model_type = raw.get("model_type", "llama")
        if model_type in UNSUPPORTED_MODEL_TYPES:
            raise ValueError(
                f"target architecture {model_type!r} is not supported by the "
                f"capture forward: {UNSUPPORTED_MODEL_TYPES[model_type]}. "
                "Capture its hidden states externally and train on them as "
                "reference .ckpt features instead."
            )
        kw: Dict[str, Any] = {}
        if model_type in ("gemma3", "gemma3_text"):
            kw.update(
                norm_style="gemma",
                sandwich_norms=True,
                embed_scale=float(raw["hidden_size"]) ** 0.5,
                query_pre_attn_scalar=raw.get("query_pre_attn_scalar", 256),
                rope_local_base_freq=raw.get("rope_local_base_freq", 10000.0),
                attn_logit_softcapping=raw.get("attn_logit_softcapping"),
                hidden_act=raw.get("hidden_activation", "gelu_pytorch_tanh"),
            )
        if model_type == "gpt_oss":
            kw.update(
                attention_sinks=True,
                moe_variant="gptoss",
                num_experts=raw.get("num_local_experts", 0) or 0,
                num_experts_per_tok=raw.get("num_experts_per_tok", 0) or 0,
                moe_intermediate_size=raw["intermediate_size"],
            )
        if model_type in ("deepseek_v2", "deepseek_v3", "kimi_k2"):
            # kimi_k2 checkpoints are DeepseekV3-architecture
            v3ish = model_type != "deepseek_v2"
            kw.update(
                attn_variant="mla",
                q_lora_rank=raw.get("q_lora_rank"),
                kv_lora_rank=raw["kv_lora_rank"],
                qk_nope_head_dim=raw["qk_nope_head_dim"],
                qk_rope_head_dim=raw["qk_rope_head_dim"],
                v_head_dim=raw["v_head_dim"],
                # both rotate interleaved channel pairs (v3 by
                # rope_interleave, v2 by its complex-pair rotary)
                rope_interleave=raw.get("rope_interleave", True),
                mla_logit_mscale=v3ish,
                moe_variant="deepseek",
                num_experts=raw.get("n_routed_experts", 0) or 0,
                n_shared_experts=raw.get("n_shared_experts", 0) or 0,
                routed_scaling_factor=raw.get("routed_scaling_factor", 1.0),
                scoring_func=raw.get(
                    "scoring_func", "sigmoid" if v3ish else "softmax"),
                topk_method=raw.get(
                    "topk_method", "noaux_tc" if v3ish else "greedy"),
                n_group=raw.get("n_group", 1) or 1,
                topk_group=raw.get("topk_group", 1) or 1,
                first_k_dense_replace=raw.get("first_k_dense_replace", 0),
                num_experts_per_tok=raw.get("num_experts_per_tok", 0) or 0,
                # v2's gate never normalises its top-k weights
                norm_topk_prob=raw.get("norm_topk_prob", False) and v3ish,
            )
        if model_type in ("llama4", "llama4_text"):
            n_layers = raw["num_hidden_layers"]
            step = raw.get("interleave_moe_layer_step", 1) or 1
            # a NoPE layer every no_rope_layer_interval layers (1 = rope)
            interval = raw.get("no_rope_layer_interval", 4) or 4
            no_rope = tuple(
                raw.get("no_rope_layers")
                or (int((i + 1) % interval != 0) for i in range(n_layers)))
            kw.update(
                moe_variant="llama4",
                num_experts=raw.get("num_local_experts", 0) or 0,
                num_experts_per_tok=raw.get("num_experts_per_tok", 1) or 1,
                moe_layers=tuple(raw.get("moe_layers")
                                 or range(step - 1, n_layers, step)),
                intermediate_size_mlp=raw.get("intermediate_size_mlp"),
                no_rope_layers=no_rope,
                # rope layers attend within chunks, nope layers globally
                layer_types=tuple(
                    raw.get("layer_types")
                    or ("chunked_attention" if r else "full_attention"
                        for r in no_rope)),
                attention_chunk_size=raw.get("attention_chunk_size", 8192),
                qk_l2_norm=raw.get("use_qk_norm", False),
                attn_temperature_tuning=bool(
                    raw.get("attn_temperature_tuning", False)),
                attn_scale=raw.get("attn_scale", 0.1),
                floor_scale=raw.get("floor_scale", 8192.0),
                rope_interleave=True,
            )
        if model_type in ("qwen2_5_vl", "qwen2_vl"):
            # the composite config's language tower; vision features enter
            # through inputs_embeds
            text = dict(raw.get("text_config") or {})
            for key in ("vocab_size", "tie_word_embeddings"):
                if key not in text and key in raw:
                    text[key] = raw[key]
            raw = {**raw, **text} if text else raw
            model_type = f"{model_type}_text"
        if model_type == "longcat_flash":
            kw.update(
                attn_variant="mla",
                dual_sublayer=True,
                mla_lora_scaling=True,
                rope_interleave=True,
                mla_logit_mscale=True,
                q_lora_rank=raw.get("q_lora_rank"),
                kv_lora_rank=raw.get("kv_lora_rank", 512),
                qk_nope_head_dim=raw.get("qk_nope_head_dim", 128),
                qk_rope_head_dim=raw.get("qk_rope_head_dim", 64),
                v_head_dim=raw.get("v_head_dim", 128),
                moe_variant="longcat",
                num_experts=raw.get("n_routed_experts", 0) or 0,
                zero_expert_num=raw.get("zero_expert_num", 0) or 0,
                num_experts_per_tok=raw.get("moe_topk", 0) or 0,
                routed_scaling_factor=raw.get("routed_scaling_factor", 1.0),
                router_bias=raw.get("router_bias", False),
                moe_intermediate_size=raw.get("expert_ffn_hidden_size"),
            )
        if model_type == "qwen3_next":
            n_layers = raw["num_hidden_layers"]
            interval = raw.get("full_attention_interval", 4) or 4
            kw.update(
                qk_norm=True,
                attn_output_gate=True,
                shared_expert_gated=True,
                # zero-centred RMSNorm with the fp32 product: gemma's
                norm_style="gemma",
                partial_rotary_factor=raw.get("partial_rotary_factor", 0.25),
                layer_types=tuple(
                    raw.get("layer_types")
                    or ("linear_attention" if (i + 1) % interval
                        else "full_attention" for i in range(n_layers))),
                linear_num_value_heads=raw.get("linear_num_value_heads", 32),
                linear_num_key_heads=raw.get("linear_num_key_heads", 16),
                linear_key_head_dim=raw.get("linear_key_head_dim", 128),
                linear_value_head_dim=raw.get("linear_value_head_dim", 128),
                linear_conv_kernel_dim=raw.get("linear_conv_kernel_dim", 4),
            )
        if model_type == "glm4_moe":
            kw.update(
                qk_norm=raw.get("use_qk_norm", False),
                partial_rotary_factor=raw.get("partial_rotary_factor", 0.5),
                moe_variant="deepseek",
                num_experts=raw.get("n_routed_experts", 0) or 0,
                n_shared_experts=raw.get("n_shared_experts", 0) or 0,
                routed_scaling_factor=raw.get("routed_scaling_factor", 1.0),
                scoring_func="sigmoid",
                topk_method="noaux_tc",
                n_group=raw.get("n_group", 1) or 1,
                topk_group=raw.get("topk_group", 1) or 1,
                first_k_dense_replace=raw.get("first_k_dense_replace", 0),
                num_experts_per_tok=raw.get("num_experts_per_tok", 0) or 0,
                norm_topk_prob=raw.get("norm_topk_prob", False),
            )
        defaults = dict(
            num_experts=raw.get("num_experts", 0) or 0,
            num_experts_per_tok=raw.get("num_experts_per_tok", 0) or 0,
            norm_topk_prob=raw.get("norm_topk_prob", False),
            moe_intermediate_size=raw.get("moe_intermediate_size"),
            qk_norm=model_type in ("qwen3", "qwen3_moe"),
            hidden_act=raw.get("hidden_act", "silu"),
            partial_rotary_factor=raw.get("partial_rotary_factor", 1.0),
            layer_types=tuple(raw.get("layer_types", []) or []),
            logits_mup_width_multiplier=raw.get(
                "logits_mup_width_multiplier"),
        )
        defaults.update(kw)
        return cls(
            vocab_size=raw["vocab_size"],
            hidden_size=raw["hidden_size"],
            # longcat names the dense-MLP width ffn_hidden_size
            intermediate_size=(raw.get("intermediate_size")
                               or raw["ffn_hidden_size"]),
            # longcat's num_hidden_layers counts MLA sublayers: its logical
            # layers are num_layers
            num_hidden_layers=(raw["num_layers"]
                               if model_type == "longcat_flash"
                               else raw["num_hidden_layers"]),
            num_attention_heads=raw["num_attention_heads"],
            num_key_value_heads=raw.get(
                "num_key_value_heads", raw["num_attention_heads"]),
            head_dim=raw.get("head_dim"),
            # HF omits default-valued keys; llama4's RMSNorm default eps is
            # 1e-5, the others' 1e-6
            rms_norm_eps=raw.get(
                "rms_norm_eps",
                1e-5 if model_type in ("llama4", "llama4_text") else 1e-6),
            rope_theta=raw.get("rope_theta", 10000.0),
            rope_scaling=raw.get("rope_scaling"),
            max_position_embeddings=raw.get("max_position_embeddings", 32768),
            tie_word_embeddings=raw.get("tie_word_embeddings", False),
            model_type=model_type,
            decoder_sparse_step=raw.get("decoder_sparse_step", 1) or 1,
            mlp_only_layers=tuple(raw.get("mlp_only_layers", []) or []),
            sliding_window=raw.get("sliding_window"),
            **defaults,
        )


def load_target_params(
    path: str, config: TargetConfig, dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None, *, mesh: Optional[Mesh] = None,
    expert_parallel: bool = False,
) -> Dict[str, torch.Tensor]:
    """Every decoder weight of the HF safetensors checkpoint at ``path``
    (one ``model.safetensors`` or shards named by a ``*.index.json``), on
    CUDA unless the caller names another device; floating tensors in
    ``dtype``, the others as they are. A VL composite checkpoint's text
    tower (``model.language_model.*``) is read as ``model.*`` and its
    vision tower (``model.visual.*``) skipped. On a capture ``mesh``: this
    rank's :class:`~.sharding.ShardedParams` (only its slices' bytes read;
    with ``expert_parallel`` its experts stacked, the others' skipped)."""
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

    vl_text = config.model_type in _VL_TEXT

    def canonical(key: str) -> Optional[str]:
        if vl_text:
            if key.startswith("model.visual."):
                return None
            if key.startswith("model.language_model."):
                return "model." + key[len("model.language_model."):]
        return key

    wanted_prefixes = ("model.", "lm_head.")
    by_shard: Dict[str, List[str]] = {}
    for key, shard in key_to_shard.items():
        if key.startswith(wanted_prefixes) and canonical(key) is not None:
            by_shard.setdefault(shard, []).append(key)

    params: Dict[str, torch.Tensor] = {}
    if mesh is not None:
        params = load_sharded(
            {os.path.join(path, shard): [(k, canonical(k)) for k in keys]
             for shard, keys in by_shard.items()},
            config, dtype, device, mesh, expert_parallel)
    else:
        for shard, keys in sorted(by_shard.items()):
            tensors = read_safetensors_tensors(os.path.join(path, shard),
                                               keys)
            for key, value in tensors.items():
                value = value.to(device)
                params[canonical(key)] = (
                    value.to(dtype) if value.is_floating_point() else value)
            del tensors
    if config.tie_word_embeddings and "lm_head.weight" not in params:
        params["lm_head.weight"] = params["model.embed_tokens.weight"]
        if mesh is not None:  # the embedding's slice, sharded alike
            params.dims["lm_head.weight"] = params.dims[
                "model.embed_tokens.weight"]
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


# -- norms, activations and rope helpers -----------------------------------

def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    return weight.to(dtype) * x32.to(dtype)


def _rms_gemma(x: torch.Tensor, weight: torch.Tensor, eps: float
               ) -> torch.Tensor:
    """Gemma RMSNorm: zero-centred weight, the fp32 product before the
    dtype cast (llama's casts before multiplying)."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    return (x32 * (1.0 + weight.float())).to(dtype)


def _norm(cfg: TargetConfig, x: torch.Tensor, weight: torch.Tensor
          ) -> torch.Tensor:
    if cfg.norm_style == "gemma":
        return _rms_gemma(x, weight, cfg.rms_norm_eps)
    return _rms(x, weight, cfg.rms_norm_eps)


def _l2norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Weightless RMS normalisation (llama4's qk norm)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype)


def _interleave_to_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved rope channels (x0, y0, x1, y1, ...) to the half layout
    (x0, x1, ..., y0, y1, ...)."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def _apply_partial_rope(q, k, cos, sin, rot_dim: int, interleave: bool):
    """Rope on the first ``rot_dim`` channels only (glm4_moe, phi partial
    rotary), those channels first reordered from interleaved pairs when
    ``interleave`` (deepseek, llama4)."""
    q_r, k_r = q[..., :rot_dim], k[..., :rot_dim]
    if interleave:
        q_r, k_r = _interleave_to_half(q_r), _interleave_to_half(k_r)
    q_r, k_r = apply_rope(q_r, k_r, cos, sin)
    if rot_dim == q.shape[-1]:
        return q_r, k_r
    return (torch.cat([q_r, q[..., rot_dim:]], dim=-1),
            torch.cat([k_r, k[..., rot_dim:]], dim=-1))


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


def _band_bias(bias: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``bias`` with the (query, key) pairs outside ``keep`` [S, S] masked."""
    return bias + torch.where(keep, 0.0, NEG_INF).to(bias.dtype)[None, None]


# -- attention -------------------------------------------------------------

def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, scale: float, *,
            sinks: Optional[torch.Tensor] = None,
            softcap: Optional[float] = None) -> torch.Tensor:
    """Grouped-query softmax attention, plain: q [B, H, S, Dq], k
    [B, KVH, S, Dq], v [B, KVH, S, Dv], bias [B, 1, S, S] → [B, S, H·Dv].
    The scores are the fp32 products of the inputs (bf16 products are exact
    in fp32), the softmax fp32, the probabilities cast to v's dtype for the
    product. ``sinks`` [H]: learned per-head logits, one extra softmax
    column dropped from the probabilities (gpt-oss); ``softcap``: the tanh
    logit cap (gemma3)."""
    b, h, s, dq = q.shape
    kvh = k.shape[1]
    g = h // kvh
    qg = q.reshape(b, kvh, g, s, dq)
    w = torch.matmul(qg.float(), k.float()[:, :, None].transpose(-1, -2))
    w.mul_(scale)
    if softcap:
        w = torch.tanh(w / softcap) * softcap
    w.add_(bias[:, :, None])
    if sinks is not None:
        sink = sinks.float().reshape(1, kvh, g, 1, 1).expand(b, kvh, g, s, 1)
        w = torch.cat([w, sink], dim=-1)
        p = torch.softmax(w, dim=-1)[..., :-1].to(v.dtype)
    else:
        p = torch.softmax(w, dim=-1).to(v.dtype)
    del w
    attn = torch.matmul(p, v[:, :, None])
    dv = v.shape[-1]
    return attn.reshape(b, h, s, dv).transpose(1, 2).reshape(b, s, h * dv)


def _linear(params, key: str, x: torch.Tensor) -> torch.Tensor:
    out = torch.matmul(x, params[f"{key}.weight"].to(x.dtype).T)
    bias = params.get(f"{key}.bias")
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def _std_attention(params, cfg: TargetConfig, prefix: str, y: torch.Tensor,
                   bias: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   layer_idx: int = 0) -> torch.Tensor:
    """GQA attention of the standard families: phi3's fused ``qkv_proj`` or
    separate projections, qwen3_next's output gate inside ``q_proj``,
    per-head q/k norms (qwen3, gemma), mrope on [3, B, S, D] tables,
    partial and interleaved rotary, llama4's NoPE layers with temperature
    tuning and its L2 qk norm after rope, ``query_pre_attn_scalar``,
    sinks and the logit softcap."""
    b, s, _ = y.shape
    d = cfg.resolved_head_dim
    h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    ap = f"{prefix}.self_attn"
    out_gate = None
    if f"{ap}.qkv_proj.weight" in params:
        qkv = _linear(params, f"{ap}.qkv_proj", y)
        q, k, v = torch.split(qkv, [h * d, kvh * d, kvh * d], dim=-1)
    elif cfg.attn_output_gate:
        # q_proj emits per-head (query, output gate) halves
        qg = _linear(params, f"{ap}.q_proj", y).reshape(b, s, h, 2 * d)
        q, out_gate = qg[..., :d], qg[..., d:].reshape(b, s, h * d)
        k = _linear(params, f"{ap}.k_proj", y)
        v = _linear(params, f"{ap}.v_proj", y)
    else:
        q = _linear(params, f"{ap}.q_proj", y)
        k = _linear(params, f"{ap}.k_proj", y)
        v = _linear(params, f"{ap}.v_proj", y)
    q = q.reshape(b, s, h, d)
    k = k.reshape(b, s, kvh, d)
    v = v.reshape(b, s, kvh, d)
    if cfg.qk_norm or cfg.norm_style == "gemma":
        q = _norm(cfg, q, params[f"{ap}.q_norm.weight"])
        k = _norm(cfg, k, params[f"{ap}.k_norm.weight"])
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    use_rope = bool(cfg.no_rope_layers[layer_idx]) if cfg.no_rope_layers \
        else True
    if use_rope and cos.ndim == 4:
        q, k = apply_multimodal_rope(q, k, cos, sin, cfg.mrope_section)
    elif use_rope:
        q, k = _apply_partial_rope(q, k, cos, sin, cos.shape[-1],
                                   cfg.rope_interleave)
        if cfg.qk_l2_norm:
            q = _l2norm(q, cfg.rms_norm_eps)
            k = _l2norm(k, cfg.rms_norm_eps)
    elif cfg.attn_temperature_tuning:
        # llama4's NoPE layers: a per-position query temperature
        pos = torch.arange(s, dtype=torch.float32, device=q.device)
        scales = (torch.log1p(torch.floor((pos + 1.0) / cfg.floor_scale))
                  * cfg.attn_scale + 1.0)
        q = (q * scales[None, None, :, None]).to(q.dtype)
    scale = (cfg.query_pre_attn_scalar ** -0.5
             if cfg.query_pre_attn_scalar is not None else d ** -0.5)
    sinks = params.get(f"{ap}.sinks") if cfg.attention_sinks else None
    attn = _attend(q, k, v, bias, scale, sinks=sinks,
                   softcap=cfg.attn_logit_softcapping)
    if out_gate is not None:
        attn = attn * torch.sigmoid(out_gate)
    return _linear(params, f"{ap}.o_proj", attn)


def _mla_attention(params, cfg: TargetConfig, prefix: str, y: torch.Tensor,
                   bias: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   ap: Optional[str] = None) -> torch.Tensor:
    """Multi-head latent attention (deepseek v2/v3, kimi, longcat): an
    optional q LoRA, the compressed kv latent and a rope key shared by all
    heads, q/k of nope + rope channels and v of its own width. ``ap``: the
    attention module's path (longcat's sublayers are ``self_attn.{0,1}``);
    ``cfg.mla_lora_scaling``: longcat rescales the LoRA outputs by
    sqrt(hidden / rank)."""
    b, s, _ = y.shape
    heads = cfg.num_attention_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    qk_dim = nope + rope
    vd = cfg.v_head_dim
    ap = ap or f"{prefix}.self_attn"
    # the LoRA norms take the RMSNorm default eps, not rms_norm_eps
    lora_eps = 1e-6
    if cfg.q_lora_rank:
        qa = _linear(params, f"{ap}.q_a_proj", y)
        qa = _rms(qa, params[f"{ap}.q_a_layernorm.weight"], lora_eps)
        q = _linear(params, f"{ap}.q_b_proj", qa)
    else:
        q = _linear(params, f"{ap}.q_proj", y)
    q = q.reshape(b, s, heads, qk_dim).transpose(1, 2)
    if cfg.mla_lora_scaling and cfg.q_lora_rank:
        q = q * (cfg.hidden_size / cfg.q_lora_rank) ** 0.5
    q_pass, q_rot = q[..., :nope], q[..., nope:]

    ckv = _linear(params, f"{ap}.kv_a_proj_with_mqa", y)
    k_pass, k_rot = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    k_pass = _rms(k_pass, params[f"{ap}.kv_a_layernorm.weight"], lora_eps)
    if cfg.mla_lora_scaling:
        k_pass = k_pass * (cfg.hidden_size / cfg.kv_lora_rank) ** 0.5
    kv = _linear(params, f"{ap}.kv_b_proj", k_pass)
    kv = kv.reshape(b, s, heads, nope + vd).transpose(1, 2)
    k_pass, v = kv[..., :nope], kv[..., nope:]
    k_rot = k_rot.reshape(b, 1, s, rope)

    q_rot, k_rot = _apply_partial_rope(q_rot, k_rot, cos, sin, rope,
                                       cfg.rope_interleave)
    q = torch.cat([q_pass, q_rot], dim=-1)
    k = torch.cat([k_pass, k_rot.expand(b, heads, s, rope)], dim=-1)

    scale = qk_dim ** -0.5
    if cfg.mla_logit_mscale and cfg.rope_scaling:
        mscale_all_dim = cfg.rope_scaling.get("mscale_all_dim", 0)
        factor = cfg.rope_scaling.get("factor", 1.0)
        if mscale_all_dim:
            m = (0.1 * mscale_all_dim * math.log(factor) + 1.0
                 if factor > 1 else 1.0)
            scale = scale * m * m
    attn = _attend(q, k, v, bias, scale)
    return _linear(params, f"{ap}.o_proj", attn)


def _chunk_gated_delta_rule(q, k, v, g, beta, chunk_size: int = 64
                            ) -> torch.Tensor:
    """The chunked gated delta rule in fp32: q/k [B, S, H, dk], v
    [B, S, H, dv], g/beta [B, S, H] → [B, S, H, dv] in v's dtype. Inside a
    chunk the mixing matrix is one unit-lower-triangular solve; across
    chunks a plain loop carries the [dk, dv] state."""
    in_dtype = v.dtype

    def l2(x):  # the sum of squares, not the mean
        x = x.float()
        return x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + 1e-6)

    q = l2(q).transpose(1, 2)
    k = l2(k).transpose(1, 2)
    v = v.float().transpose(1, 2)
    g = g.float().transpose(1, 2)
    beta = beta.float().transpose(1, 2)
    b, h, s, dk = k.shape
    dv = v.shape[-1]
    c = min(chunk_size, s)
    pad = (-s) % c
    nc = (s + pad) // c
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v))
        g, beta = (F.pad(x, (0, pad)) for x in (g, beta))
    q = q * dk ** -0.5
    v_beta = v * beta[..., None]
    k_beta = k * beta[..., None]
    q, k, v_beta, k_beta = (x.reshape(b, h, nc, c, x.shape[-1])
                            for x in (q, k, v_beta, k_beta))
    g = torch.cumsum(g.reshape(b, h, nc, c), dim=-1)

    ones = torch.ones(c, c, dtype=torch.bool, device=q.device)
    lower, strict = torch.tril(ones), torch.tril(ones, -1)
    gd = g[..., :, None] - g[..., None, :]
    decay = torch.where(lower, torch.exp(torch.where(lower, gd, 0.0)), 0.0)
    a_strict = torch.where(strict, torch.matmul(k_beta, k.transpose(-1, -2))
                           * decay, 0.0)
    m_mat = torch.eye(c, dtype=torch.float32, device=q.device) + a_strict
    u = torch.linalg.solve_triangular(m_mat, v_beta, upper=False,
                                      unitriangular=True)
    w = torch.linalg.solve_triangular(m_mat, k_beta * torch.exp(g)[..., None],
                                      upper=False, unitriangular=True)

    state = torch.zeros(b, h, dk, dv, dtype=torch.float32, device=q.device)
    outs = []
    for i in range(nc):
        q_i, k_i, u_i, w_i = q[:, :, i], k[:, :, i], u[:, :, i], w[:, :, i]
        g_i, decay_i = g[:, :, i], decay[:, :, i]
        attn = torch.where(lower, torch.matmul(q_i, k_i.transpose(-1, -2))
                           * decay_i, 0.0)
        v_new = u_i - torch.matmul(w_i, state)
        outs.append(torch.matmul(q_i * torch.exp(g_i)[..., None], state)
                    + torch.matmul(attn, v_new))
        g_last = g_i[..., -1]
        kd = k_i * torch.exp(g_last[..., None] - g_i)[..., None]
        state = (state * torch.exp(g_last)[..., None, None]
                 + torch.matmul(kd.transpose(-1, -2), v_new))
    out = torch.stack(outs, dim=2).reshape(b, h, nc * c, dv)[:, :, :s]
    return out.transpose(1, 2).to(in_dtype)


def _gdn_attention(params, cfg: TargetConfig, prefix: str, y: torch.Tensor,
                   token_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """qwen3_next's gated DeltaNet layer: the fused qkvz/ba projections in
    per-key-head layout, a causal depthwise conv and silu over (q, k, v),
    the chunked gated delta rule, the gated RMSNorm (norm, weight, then the
    silu(z) gate) and the out projection. Padding is zeroed on entry, so
    with right padding no padded position feeds a real one."""
    b, s, _ = y.shape
    nk, nv = cfg.linear_num_key_heads, cfg.linear_num_value_heads
    dk, dv = cfg.linear_key_head_dim, cfg.linear_value_head_dim
    key_dim, value_dim = nk * dk, nv * dv
    r = nv // nk
    ap = f"{prefix}.linear_attn"
    if token_valid is not None:
        y = y * token_valid.to(device=y.device, dtype=y.dtype)[..., None]
    qkvz = _linear(params, f"{ap}.in_proj_qkvz", y).reshape(
        b, s, nk, 2 * dk + 2 * r * dv)
    ba = _linear(params, f"{ap}.in_proj_ba", y).reshape(b, s, nk, 2 * r)
    q = qkvz[..., :dk].reshape(b, s, key_dim)
    k = qkvz[..., dk:2 * dk].reshape(b, s, key_dim)
    v = qkvz[..., 2 * dk:2 * dk + r * dv].reshape(b, s, value_dim)
    z = qkvz[..., 2 * dk + r * dv:].reshape(b, s, nv, dv)
    bg = ba[..., :r].reshape(b, s, nv)
    a = ba[..., r:].reshape(b, s, nv)

    mixed = torch.cat([q, k, v], dim=-1).transpose(1, 2)  # [B, conv, S]
    w = params[f"{ap}.conv1d.weight"]                     # [conv, 1, K]
    conv = F.conv1d(F.pad(mixed, (w.shape[-1] - 1, 0)), w.to(mixed.dtype),
                    groups=mixed.shape[1])
    mixed = F.silu(conv).transpose(1, 2)
    q, k, v = torch.split(mixed, [key_dim, key_dim, value_dim], dim=-1)
    q = q.reshape(b, s, nk, dk)
    k = k.reshape(b, s, nk, dk)
    v = v.reshape(b, s, nv, dv)
    if r > 1:
        q = q.repeat_interleave(r, dim=2)
        k = k.repeat_interleave(r, dim=2)

    beta = torch.sigmoid(bg.float())
    g = -torch.exp(params[f"{ap}.A_log"].float()) * F.softplus(
        a.float() + params[f"{ap}.dt_bias"].float())
    core = _chunk_gated_delta_rule(q, k, v, g, beta)

    c32 = core.float()
    var = torch.mean(c32 * c32, dim=-1, keepdim=True)
    normed = params[f"{ap}.norm.weight"].float() * (
        c32 * torch.rsqrt(var + cfg.rms_norm_eps))
    gated = (normed * F.silu(z.float())).to(y.dtype)
    return _linear(params, f"{ap}.out_proj", gated.reshape(b, s, value_dim))


def _dense_mlp(params, cfg: TargetConfig, prefix: str, y: torch.Tensor
               ) -> torch.Tensor:
    """Gate/up/down MLP, or phi3's fused ``gate_up_proj`` (gate first)."""
    act = _act(cfg.hidden_act)
    if f"{prefix}.gate_up_proj.weight" in params:
        gate, up = _linear(params, f"{prefix}.gate_up_proj", y).chunk(2, -1)
    else:
        gate = _linear(params, f"{prefix}.gate_proj", y)
        up = _linear(params, f"{prefix}.up_proj", y)
    return _linear(params, f"{prefix}.down_proj", act(gate) * up)


# -- mixture of experts ----------------------------------------------------

#: one expert's computation: (expert id, its input rows [n, h]) → [n, h]
ExpertFn = Callable[[int, torch.Tensor], torch.Tensor]


def _topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis, largest first, ties to the lower
    index (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _sort_assignments(top_i: torch.Tensor, num_experts: int):
    """The t·k (token, expert) assignments sorted by expert id, stably (a
    group keeps token order) → (order [m], the group sizes on the host).
    Ids of ``num_experts`` and above (longcat's zero experts) sort last and
    join no group."""
    flat = top_i.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sizes = torch.bincount(flat, minlength=num_experts)[:num_experts]
    return order, sizes.tolist()


def _expert_mix(x: torch.Tensor, top_w: torch.Tensor, top_i: torch.Tensor,
                num_experts: int, expert: ExpertFn, impl: str, *,
                scale_inputs: bool = False) -> torch.Tensor:
    """Σ_k w·expert(x) for each token of ``x`` [t, h], from the routing
    weights and ids [t, k] (ids ≥ ``num_experts`` contribute nothing).
    ``scale_inputs``: the weight scales the expert's input instead of its
    output (llama4). ``gathered``: the assignments sorted by expert, one
    product per expert over its contiguous group (the group sizes read to
    the host once), the rows put back in token order by a gather and summed
    over k. ``dense``: every expert over every token, weighted (0 off its
    assignments), summed over the experts in order. Neither uses atomics,
    so both repeat bit for bit."""
    t, h = x.shape
    k = top_i.shape[1]
    if impl == "dense":
        out = torch.zeros_like(x)
        for e in range(num_experts):
            w_e = torch.where(top_i == e, top_w, 0).sum(-1)[:, None]
            if scale_inputs:
                out = out + expert(e, x * w_e.to(x.dtype))
            else:
                y = expert(e, x)
                out = out + w_e.to(y.dtype) * y
        return out
    order, sizes = _sort_assignments(top_i, num_experts)
    rows = x[order // k]
    w_sorted = top_w.reshape(-1)[order][:, None]
    if scale_inputs:
        rows = rows * w_sorted.to(rows.dtype)
    out_rows = torch.zeros_like(rows)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            out_rows[start:start + n] = expert(e, rows[start:start + n])
        start += n
    if not scale_inputs:
        out_rows = out_rows * w_sorted.to(out_rows.dtype)
    return out_rows[torch.argsort(order)].reshape(t, k, h).sum(dim=1)


def _swiglu_expert(params, cfg: TargetConfig, prefix: str) -> ExpertFn:
    """Experts of their own gate/up/down weights under ``prefix``."""
    act = _act(cfg.hidden_act)

    def expert(e: int, rows: torch.Tensor) -> torch.Tensor:
        p = f"{prefix}.{e}"
        gate = _linear(params, f"{p}.gate_proj", rows)
        up = _linear(params, f"{p}.up_proj", rows)
        return _linear(params, f"{p}.down_proj", act(gate) * up)

    return expert


def _moe_route(router_weight: torch.Tensor, cfg: TargetConfig,
               x: torch.Tensor):
    """The qwen router: an fp32 softmax over the logits, its top k, the
    weights renormalised when ``norm_topk_prob``."""
    logits = torch.matmul(x, router_weight.to(x.dtype).T)
    probs = torch.softmax(logits.float(), dim=-1)
    top_w, top_i = _topk(probs, cfg.num_experts_per_tok)
    if cfg.norm_topk_prob:
        top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    return top_w, top_i


def _deepseek_route(gate_w: torch.Tensor,
                    correction_bias: Optional[torch.Tensor],
                    cfg: TargetConfig, x32: torch.Tensor):
    """The deepseek v2/v3 router on fp32 inputs: softmax (v2) or sigmoid
    (v3) scores; ``greedy`` top k, or a top k among the best
    ``topk_group`` of ``n_group`` groups (``group_limited_greedy`` by each
    group's best score, ``noaux_tc`` by its best two after the correction
    bias, which steers the choice only); the weights from the uncorrected
    scores, renormalised when ``norm_topk_prob``, times
    ``routed_scaling_factor``."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = torch.matmul(x32, gate_w.float().T)
    if cfg.scoring_func == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    if cfg.topk_method == "greedy":
        top_w, top_i = _topk(scores, k)
    else:
        if cfg.topk_method == "noaux_tc":
            choice = scores + (0.0 if correction_bias is None
                               else correction_bias.float())
            grp = choice.reshape(-1, cfg.n_group, e // cfg.n_group)
            group_scores = _topk(grp, 2)[0].sum(dim=-1)
        elif cfg.topk_method == "group_limited_greedy":
            choice = scores
            grp = choice.reshape(-1, cfg.n_group, e // cfg.n_group)
            group_scores = grp.max(dim=-1).values
        else:
            raise ValueError(f"unknown topk_method {cfg.topk_method!r}")
        group_idx = _topk(group_scores, cfg.topk_group)[1]
        groups = torch.arange(cfg.n_group, device=x32.device)
        group_mask = (group_idx[..., None] == groups).any(dim=-2)
        score_mask = group_mask.repeat_interleave(e // cfg.n_group, dim=-1)
        top_i = _topk(torch.where(score_mask, choice, 0.0), k)[1]
        top_w = torch.gather(scores, -1, top_i)
    if cfg.norm_topk_prob and k > 1:
        top_w = top_w / (torch.sum(top_w, dim=-1, keepdim=True) + 1e-20)
    return top_w * cfg.routed_scaling_factor, top_i


def _moe_qwen(params, cfg: TargetConfig, prefix: str, y: torch.Tensor,
              impl: str):
    b, s, h = y.shape
    x = y.reshape(b * s, h)
    top_w, top_i = _moe_route(params[f"{prefix}.mlp.gate.weight"], cfg, x)
    out = _expert_mix(x, top_w, top_i, cfg.num_experts,
                      _swiglu_expert(params, cfg, f"{prefix}.mlp.experts"),
                      impl)
    return out.reshape(b, s, h).to(y.dtype), top_i


def _moe_deepseek(params, cfg: TargetConfig, prefix: str, y: torch.Tensor,
                  impl: str):
    """Routed experts and the always-on shared experts."""
    b, s, h = y.shape
    x = y.reshape(b * s, h)
    top_w, top_i = _deepseek_route(
        params[f"{prefix}.mlp.gate.weight"],
        params.get(f"{prefix}.mlp.gate.e_score_correction_bias"), cfg,
        x.float())
    out = _expert_mix(x, top_w, top_i, cfg.num_experts,
                      _swiglu_expert(params, cfg, f"{prefix}.mlp.experts"),
                      impl)
    out = out.reshape(b, s, h).to(y.dtype)
    if cfg.n_shared_experts:
        out = out + _dense_mlp(params, cfg, f"{prefix}.mlp.shared_experts", y)
    return out, top_i


def _gptoss_route(params, cfg: TargetConfig, prefix: str, x: torch.Tensor):
    """gpt-oss's biased router: a softmax over its top-k logits."""
    logits = _linear(params, f"{prefix}.mlp.router", x)
    top_v, top_i = _topk(logits, cfg.num_experts_per_tok)
    return torch.softmax(top_v.float(), dim=-1), top_i


def _gptoss_experts(params, cfg: TargetConfig, prefix: str) -> ExpertFn:
    """gpt-oss's fused expert tensors (the ids index their first axis):
    interleaved gate/up columns, the clamped SwiGLU, biases."""
    ep = f"{prefix}.mlp.experts"
    gate_up_w, gate_up_b = (params[f"{ep}.gate_up_proj"],       # [E, h, 2i]
                            params[f"{ep}.gate_up_proj_bias"])  # [E, 2i]
    down_w, down_b = (params[f"{ep}.down_proj"],                # [E, i, h]
                      params[f"{ep}.down_proj_bias"])           # [E, h]
    alpha, limit = cfg.moe_alpha, cfg.moe_limit

    def expert(e: int, rows: torch.Tensor) -> torch.Tensor:
        gu = (torch.matmul(rows, gate_up_w[e].to(rows.dtype))
              + gate_up_b[e].to(rows.dtype))
        gate = gu[..., ::2].clamp(max=limit)
        up = gu[..., 1::2].clamp(-limit, limit)
        inner = (up + 1.0) * (gate * torch.sigmoid(gate * alpha))
        return (torch.matmul(inner.to(rows.dtype), down_w[e].to(rows.dtype))
                + down_b[e].to(rows.dtype))

    return expert


def _moe_gptoss(params, cfg: TargetConfig, prefix: str, y: torch.Tensor,
                impl: str):
    b, s, h = y.shape
    x = y.reshape(b * s, h)
    top_w, top_i = _gptoss_route(params, cfg, prefix, x)
    out = _expert_mix(x, top_w, top_i, cfg.num_experts,
                      _gptoss_experts(params, cfg, prefix), impl)
    return out.reshape(b, s, h).to(y.dtype), top_i


def _moe_llama4(params, cfg: TargetConfig, prefix: str, y: torch.Tensor,
                impl: str):
    """Top-k on the router's logits, their sigmoid scaling the experts'
    inputs; fused chunked gate/up experts; the always-on shared expert."""
    b, s, h = y.shape
    x = y.reshape(b * s, h)
    fp = f"{prefix}.feed_forward"
    logits = _linear(params, f"{fp}.router", x)
    top_v, top_i = _topk(logits, cfg.num_experts_per_tok)
    top_w = torch.sigmoid(top_v.float()).to(x.dtype)
    gate_up_w = params[f"{fp}.experts.gate_up_proj"]  # [E, h, 2i]
    down_w = params[f"{fp}.experts.down_proj"]        # [E, i, h]
    act = _act(cfg.hidden_act)

    def expert(e: int, rows: torch.Tensor) -> torch.Tensor:
        gate, up = torch.matmul(rows, gate_up_w[e].to(rows.dtype)).chunk(
            2, dim=-1)
        return torch.matmul(up * act(gate), down_w[e].to(rows.dtype))

    out = _expert_mix(x, top_w, top_i, cfg.num_experts, expert, impl,
                      scale_inputs=True)
    out = out.reshape(b, s, h).to(y.dtype)
    return out + _dense_mlp(params, cfg, f"{fp}.shared_expert", y), top_i


def _moe_longcat(params, cfg: TargetConfig, prefix: str, y: torch.Tensor,
                 impl: str):
    """longcat's shortcut MoE: an fp32 softmax router over the routed and
    the zero experts, a correction bias steering the choice only; a zero
    expert (id ≥ ``num_experts``) returns its input times its weight."""
    b, s, h = y.shape
    x = y.reshape(b * s, h)
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    rp = f"{prefix}.mlp.router"
    logits = torch.matmul(x.float(), params[f"{rp}.classifier.weight"]
                          .float().T)
    if cfg.router_bias:
        logits = logits + params[f"{rp}.classifier.bias"].float()
    scores = torch.softmax(logits, dim=-1)
    correction = params.get(f"{rp}.e_score_correction_bias")
    choice = scores if correction is None else scores + correction.float()
    top_i = _topk(choice, k)[1]
    top_w = torch.gather(scores, -1, top_i) * cfg.routed_scaling_factor
    zero = top_i >= e
    out = x.float() * torch.where(zero, top_w, 0.0).sum(-1)[:, None]
    routed = _expert_mix(x, torch.where(zero, 0.0, top_w), top_i, e,
                         _swiglu_expert(params, cfg, f"{prefix}.mlp.experts"),
                         impl)
    return (out + routed.float()).reshape(b, s, h).to(y.dtype), top_i


_MOE = {"qwen": _moe_qwen, "deepseek": _moe_deepseek, "gptoss": _moe_gptoss,
        "llama4": _moe_llama4, "longcat": _moe_longcat}


def _stacked_experts(params, cfg: TargetConfig, prefix: str) -> ExpertFn:
    """Experts of the stacked tables ``{prefix}.{gate,up,down}_stacked``
    [n, in, out] (the ids index their first axis): each product is the one
    ``_linear`` takes of the expert's HF weight."""
    act = _act(cfg.hidden_act)
    gate_w, up_w, down_w = (params[f"{prefix}.{name}_stacked"]
                            for name in ("gate", "up", "down"))

    def expert(e: int, rows: torch.Tensor) -> torch.Tensor:
        gate = torch.matmul(rows, gate_w[e].to(rows.dtype))
        up = torch.matmul(rows, up_w[e].to(rows.dtype))
        return torch.matmul(act(gate) * up, down_w[e].to(rows.dtype))

    return expert


def _moe_ep_partial(params, cfg: TargetConfig, prefix: str, y: torch.Tensor,
                    ep: int, rank: int,
                    capacity_factor: Optional[float] = None,
                    token_valid: Optional[torch.Tensor] = None):
    """Rank ``rank`` of ``ep``'s share of an MoE layer's routed experts,
    from its own experts (``stack_moe_expert_params``) → (its sum [t, h],
    the routing ids [t, k], the overflow of every rank). The routing is
    replicated work: the port's routers, as the gathered path runs them."""
    b, s, h = y.shape
    t = b * s
    x = y.reshape(t, h)
    variant = cfg.moe_variant
    if variant == "qwen":
        top_w, top_i = _moe_route(params[f"{prefix}.mlp.gate.weight"], cfg,
                                  x)
    elif variant == "deepseek":
        top_w, top_i = _deepseek_route(
            params[f"{prefix}.mlp.gate.weight"],
            params.get(f"{prefix}.mlp.gate.e_score_correction_bias"), cfg,
            x.float())
    elif variant == "gptoss":
        top_w, top_i = _gptoss_route(params, cfg, prefix, x)
    else:
        raise ValueError("moe_impl='ep' supports qwen/deepseek/gptoss MoE "
                         f"targets (got {variant!r})")
    expert = (_gptoss_experts(params, cfg, prefix) if variant == "gptoss"
              else _stacked_experts(params, cfg, f"{prefix}.mlp.experts"))
    cap = ep_capacity(t * cfg.num_experts_per_tok, ep, capacity_factor)
    out, overflow = ep_mix(x, top_w, top_i, token_valid, cfg.num_experts, ep,
                           rank, cap, expert)
    return out, top_i, overflow


def _moe_ep(params, cfg: TargetConfig, prefix: str, y: torch.Tensor,
            mesh: Mesh, capacity_factor: Optional[float],
            token_valid: Optional[torch.Tensor]):
    """Expert-parallel MoE (``_moe_mlp_ep`` of the JAX package): each rank
    computes its experts' rows within its capacity, the ranks' sums are
    all-reduced, and deepseek's shared experts, replicated dense work, are
    added after → (out [B, S, H], routing ids, overflow)."""
    b, s, h = y.shape
    out, top_i, overflow = _moe_ep_partial(
        params, cfg, prefix, y, mesh.fsdp_size, mesh.fsdp_rank,
        capacity_factor, token_valid)
    if mesh.world_size > 1:
        out = all_reduce_sum(out, mesh, mesh.fsdp_group)
    out = out.reshape(b, s, h).to(y.dtype)
    if cfg.moe_variant == "deepseek" and cfg.n_shared_experts:
        out = out + _dense_mlp(params, cfg, f"{prefix}.mlp.shared_experts", y)
    return out, top_i, overflow


def _longcat_layer(params, cfg: TargetConfig, prefix: str, x: torch.Tensor,
                   bias, cos, sin, impl: str):
    """One longcat logical layer: two MLA + dense-MLP sublayers, the
    shortcut MoE computed on the first post-attention norm's output and
    added after the second MLP."""
    shortcut = top_i = None
    for j in (0, 1):
        residual = x
        y = _norm(cfg, x, params[f"{prefix}.input_layernorm.{j}.weight"])
        x = residual + _mla_attention(params, cfg, prefix, y, bias, cos, sin,
                                      ap=f"{prefix}.self_attn.{j}")
        residual = x
        y = _norm(cfg, x,
                  params[f"{prefix}.post_attention_layernorm.{j}.weight"])
        if j == 0:
            shortcut, top_i = _moe_longcat(params, cfg, prefix, y, impl)
            x = residual + _dense_mlp(params, cfg, f"{prefix}.mlps.0", y)
        else:
            x = residual + _dense_mlp(params, cfg, f"{prefix}.mlps.1",
                                      y) + shortcut
    return x, top_i


def check_moe_impl(moe_impl: str, config: Optional[TargetConfig] = None
                   ) -> None:
    """Raise unless ``moe_impl`` is one of ``MOE_IMPLS`` and, for ``ep``
    on an MoE ``config``, its variant is one EP takes (JAX's message)."""
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"unknown MoE impl {moe_impl!r}: use one of "
                         f"{MOE_IMPLS}")
    if (moe_impl == "ep" and config is not None and config.num_experts
            and config.moe_variant not in EP_VARIANTS):
        raise ValueError("moe_impl='ep' supports qwen/deepseek/gptoss MoE "
                         f"targets (got {config.moe_variant!r})")


# -- the forward -----------------------------------------------------------

@torch.no_grad()
def target_capture_forward(
    params: Dict[str, torch.Tensor],
    config: TargetConfig,
    input_ids: torch.Tensor,                 # [B, S]
    attention_mask: Optional[torch.Tensor],  # [B, S]
    capture_layers: Sequence[int],
    compute_dtype: Optional[torch.dtype] = None,
    *,
    moe_impl: str = "gathered",
    mesh: Optional[Mesh] = None,
    moe_capacity_factor: Optional[float] = None,
    position_ids: Optional[torch.Tensor] = None,   # [B, S] or [3, B, S]
    inputs_embeds: Optional[torch.Tensor] = None,  # [B, S, H]
    routing: Optional[Dict[int, torch.Tensor]] = None,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill forward → (aux concat [B, S, L·H], post-norm last hidden
    [B, S, H]), on the device of ``params``. ``compute_dtype``: the
    activations' dtype (default the embedding's); each weight is cast to it
    as it is used. ``moe_impl``: ``gathered`` or ``dense`` (see
    ``_expert_mix``), or ``ep`` (``_moe_ep``: stacked experts, this rank's
    on a ``mesh``, which defaults to that of sharded ``params``) with
    ``moe_capacity_factor`` bounding each rank's rows (None: all of them).
    Sharded ``params`` (:class:`~.sharding.ShardedParams`) gather each
    layer's leaves before it. ``position_ids``: explicit positions, [3, B,
    S] for a VL text tower's 3-axis rope (default 0..S-1: the capture
    inputs are right-padded). ``inputs_embeds``: embeddings in place of the
    lookup, the seam where an external vision tower's features enter.
    ``routing``: when given, each MoE layer's expert ids [B·S, k] are
    stored in it under the layer's index. ``stats``: when given, its
    ``moe_overflow`` is the assignments no rank computed, summed over the
    layers (0 but under ``ep`` with a capacity factor: the capture is exact
    only at 0)."""
    cfg = config
    check_moe_impl(moe_impl, cfg)
    sharded = isinstance(params, ShardedParams)
    mesh = mesh or (params.mesh if sharded else None)
    if moe_impl == "ep" and mesh is None:
        raise ValueError("moe_impl='ep' requires a device mesh")
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
    dtype = compute_dtype or embed.dtype
    if inputs_embeds is not None:
        x = inputs_embeds.to(device)
    elif sharded:
        x = params.lookup("model.embed_tokens.weight", input_ids)
    else:
        x = embed[input_ids]
    x = x.to(dtype)
    if cfg.embed_scale:  # gemma3 scales by sqrt(hidden) in the input dtype
        x = x * torch.tensor(cfg.embed_scale, dtype=dtype, device=device)
    if attention_mask is not None:
        attention_mask = attention_mask.to(device)
    bias = make_causal_bias(attention_mask, b, s, device)
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(s, device=device)[None, :]
    sliding_bias = chunked_bias = None
    if cfg.sliding_window and "sliding_attention" in cfg.layer_types:
        sliding_bias = _band_bias(bias, (qi - ki) < cfg.sliding_window)
    if (cfg.attention_chunk_size and "chunked_attention" in cfg.layer_types
            and s > cfg.attention_chunk_size):
        # llama4's rope layers attend within chunks of positions
        chunk = cfg.attention_chunk_size
        chunked_bias = _band_bias(bias, (qi // chunk) == (ki // chunk))
    if position_ids is None:
        position_ids = torch.arange(s, device=device)[None].expand(b, s)
    position_ids = position_ids.to(device)
    if cfg.mrope_section and position_ids.ndim == 2:
        # text-only mrope: three identical position axes
        position_ids = position_ids[None].expand(3, b, s)
    # MLA ropes its shared rope channels; glm/phi a fraction of the head
    rot_dim = (cfg.qk_rope_head_dim if cfg.attn_variant == "mla"
               else int(cfg.resolved_head_dim * cfg.partial_rotary_factor))
    spec = RopeSpec.from_config(cfg)
    if spec.head_dim != rot_dim:
        spec = dataclasses.replace(spec, head_dim=rot_dim)
    cos, sin = rope_cos_sin(spec, position_ids, s, dtype=dtype)
    cos_local = sin_local = None
    if cfg.rope_local_base_freq and "sliding_attention" in cfg.layer_types:
        # gemma3's sliding layers: their own base, default rope
        local = RopeSpec(head_dim=rot_dim, base=cfg.rope_local_base_freq,
                         max_position_embeddings=cfg.max_position_embeddings)
        cos_local, sin_local = rope_cos_sin(local, position_ids, s,
                                            dtype=dtype)

    captured: Dict[int, torch.Tensor] = {}
    if -1 in capture_set:
        captured[-1] = x
    overflow = 0
    for i in range(cfg.num_hidden_layers):
        prefix = f"model.layers.{i}"
        # on a mesh: this layer's sharded leaves, whole until the next
        lp = params.layer(i) if sharded else params
        kind = cfg.layer_kind(i)
        sliding = kind == "sliding_attention"
        if sliding and sliding_bias is not None:
            bias_i = sliding_bias
        elif kind == "chunked_attention" and chunked_bias is not None:
            bias_i = chunked_bias
        else:
            bias_i = bias
        cos_i, sin_i = ((cos_local, sin_local)
                        if sliding and cos_local is not None else (cos, sin))

        if cfg.dual_sublayer:
            x, top_i = _longcat_layer(lp, cfg, prefix, x, bias_i, cos_i,
                                      sin_i, moe_impl)
            del lp
            if routing is not None:
                routing[i] = top_i
            if i in capture_set:
                captured[i] = x
            continue

        residual = x
        y = _norm(cfg, x, lp[f"{prefix}.input_layernorm.weight"])
        if kind == "linear_attention":
            attn = _gdn_attention(lp, cfg, prefix, y, attention_mask)
        elif cfg.attn_variant == "mla":
            attn = _mla_attention(lp, cfg, prefix, y, bias_i, cos_i,
                                  sin_i)
        else:
            attn = _std_attention(lp, cfg, prefix, y, bias_i, cos_i,
                                  sin_i, layer_idx=i)
        if cfg.sandwich_norms:  # gemma3 norms the block's output too
            attn = _norm(cfg, attn,
                         lp[f"{prefix}.post_attention_layernorm.weight"])
            x = residual + attn
            residual = x
            y = _norm(cfg, x,
                      lp[f"{prefix}.pre_feedforward_layernorm.weight"])
        else:
            x = residual + attn
            residual = x
            y = _norm(cfg, x,
                      lp[f"{prefix}.post_attention_layernorm.weight"])

        if cfg.is_moe_layer(i):
            y_in = y
            if moe_impl == "ep":
                y, top_i, dropped = _moe_ep(lp, cfg, prefix, y, mesh,
                                            moe_capacity_factor,
                                            attention_mask)
                overflow += dropped
            else:
                y, top_i = _MOE[cfg.moe_variant](lp, cfg, prefix, y,
                                                 moe_impl)
            if routing is not None:
                routing[i] = top_i
            if cfg.shared_expert_gated:
                # qwen3_next: a sigmoid-gated shared expert on the MoE input
                shared = _dense_mlp(lp, cfg,
                                    f"{prefix}.mlp.shared_expert", y_in)
                gate = _linear(lp, f"{prefix}.mlp.shared_expert_gate",
                               y_in)
                y = y + torch.sigmoid(gate.float()).to(shared.dtype) * shared
        else:
            # llama4 names the dense block feed_forward
            y = _dense_mlp(lp, cfg, f"{prefix}.feed_forward"
                           if cfg.moe_variant == "llama4"
                           else f"{prefix}.mlp", y)
        if cfg.sandwich_norms:
            y = _norm(cfg, y,
                      lp[f"{prefix}.post_feedforward_layernorm.weight"])
        x = residual + y
        del lp
        if i in capture_set:
            captured[i] = x
    last_hidden = _norm(cfg, x, params.whole("model.norm.weight") if sharded
                        else params["model.norm.weight"])
    if stats is not None:
        stats["moe_overflow"] = overflow
    aux = torch.cat([captured[int(i)] for i in capture_layers], dim=-1)
    return aux, last_hidden
