"""Random target checkpoints of every family the capture forward runs.

``tensor_shapes`` lists the HF key, shape and kind of every tensor a
target's decoder holds, from its ``TargetConfig`` (the key names are the
ones ``tests/test_target_families.py`` and ``tests/test_moe_ep.py`` read
from ``transformers`` checkpoints). ``TINY_FAMILIES`` holds one tiny
``config.json`` per family (hidden 32, 2-4 layers, at most 8 experts), and
``write_family_target`` writes one as an HF directory from a numpy seed
with the port's safetensors writer. ``chip_smoke.py`` writes its
full-width targets from the same shapes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from specforge_tpu_torch.models.target.transformer import TargetConfig
from specforge_tpu_torch.runtime.data_plane.feature_file import save_feature_file

V, H = 128, 32
_COMMON = dict(vocab_size=V, hidden_size=H, num_attention_heads=4,
               num_key_value_heads=2, head_dim=8, max_position_embeddings=128,
               rms_norm_eps=1e-6, rope_theta=10000.0,
               tie_word_embeddings=False)
_MLA = dict(num_key_value_heads=4, kv_lora_rank=16, qk_nope_head_dim=8,
            qk_rope_head_dim=8, v_head_dim=8)
_YARN = {"rope_type": "yarn", "factor": 40.0, "beta_fast": 32.0,
         "beta_slow": 1.0, "mscale": 0.707, "mscale_all_dim": 0.707,
         "original_max_position_embeddings": 64}

#: family name → its config.json: tiny widths, every branch of the family
TINY_FAMILIES: Dict[str, dict] = {
    "gemma3": dict(
        _COMMON, model_type="gemma3_text", intermediate_size=64,
        num_hidden_layers=3, sliding_window=4, query_pre_attn_scalar=8,
        layer_types=["sliding_attention", "sliding_attention",
                     "full_attention"],
        rope_local_base_freq=10000.0, rope_theta=1000000.0,
        attn_logit_softcapping=2.0, hidden_activation="gelu_pytorch_tanh",
        tie_word_embeddings=True),
    "phi3": dict(
        _COMMON, model_type="phi3", intermediate_size=64,
        num_hidden_layers=3, partial_rotary_factor=0.5),
    "gpt_oss": dict(
        _COMMON, model_type="gpt_oss", intermediate_size=48,
        num_hidden_layers=2, sliding_window=4,
        layer_types=["sliding_attention", "full_attention"],
        num_local_experts=4, num_experts_per_tok=2, attention_bias=True,
        rope_theta=150000.0,
        rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                      "beta_slow": 1.0,
                      "original_max_position_embeddings": 64}),
    "deepseek_v2": dict(
        _COMMON, **_MLA, model_type="deepseek_v2", intermediate_size=64,
        moe_intermediate_size=16, num_hidden_layers=3, q_lora_rank=None,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
        first_k_dense_replace=1, topk_method="greedy", n_group=1,
        topk_group=1, routed_scaling_factor=1.0, rope_scaling=_YARN),
    "deepseek_v2_group": dict(
        _COMMON, **_MLA, model_type="deepseek_v2", intermediate_size=64,
        moe_intermediate_size=16, num_hidden_layers=2, q_lora_rank=16,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
        first_k_dense_replace=0, topk_method="group_limited_greedy",
        n_group=4, topk_group=2, routed_scaling_factor=1.5),
    "deepseek_v3": dict(
        _COMMON, **_MLA, model_type="deepseek_v3", intermediate_size=64,
        moe_intermediate_size=16, num_hidden_layers=3, q_lora_rank=16,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
        first_k_dense_replace=1, n_group=2, topk_group=1,
        routed_scaling_factor=2.5, norm_topk_prob=True,
        rope_scaling=dict(_YARN, mscale=1.0, mscale_all_dim=1.0)),
    "kimi_k2": dict(
        _COMMON, **_MLA, model_type="kimi_k2", intermediate_size=64,
        moe_intermediate_size=16, num_hidden_layers=2, q_lora_rank=16,
        n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
        first_k_dense_replace=1, n_group=1, topk_group=1,
        routed_scaling_factor=2.0, norm_topk_prob=True),
    "glm4_moe": dict(
        _COMMON, model_type="glm4_moe", intermediate_size=64,
        moe_intermediate_size=16, num_hidden_layers=3,
        partial_rotary_factor=0.5, use_qk_norm=True, attention_bias=True,
        n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
        first_k_dense_replace=1, n_group=1, topk_group=1,
        routed_scaling_factor=1.0, norm_topk_prob=True),
    "llama4": dict(
        {k: v for k, v in _COMMON.items() if k != "rms_norm_eps"},
        model_type="llama4_text", intermediate_size=48,
        intermediate_size_mlp=64, num_hidden_layers=4, num_local_experts=4,
        num_experts_per_tok=1, interleave_moe_layer_step=2,
        no_rope_layer_interval=2, attention_chunk_size=4, use_qk_norm=True,
        attn_temperature_tuning=True, floor_scale=4.0, attn_scale=0.1,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32}),
    "qwen3_next": dict(
        _COMMON, model_type="qwen3_next", intermediate_size=64,
        moe_intermediate_size=16, shared_expert_intermediate_size=24,
        num_hidden_layers=4, full_attention_interval=2,
        linear_num_key_heads=2, linear_num_value_heads=4,
        linear_key_head_dim=8, linear_value_head_dim=8,
        linear_conv_kernel_dim=4, num_experts=4, num_experts_per_tok=2,
        decoder_sparse_step=1, norm_topk_prob=True,
        partial_rotary_factor=0.25),
    "longcat_flash": dict(
        _COMMON, **_MLA, model_type="longcat_flash", ffn_hidden_size=64,
        expert_ffn_hidden_size=16, num_layers=2, num_hidden_layers=4,
        q_lora_rank=16, n_routed_experts=4, zero_expert_num=2, moe_topk=2,
        routed_scaling_factor=2.0, router_bias=True, rms_norm_eps=1e-5),
    "qwen2_5_vl": dict(
        model_type="qwen2_5_vl",
        text_config=dict(
            _COMMON, model_type="qwen2_5_vl_text", intermediate_size=64,
            num_hidden_layers=3, attention_bias=True,
            rope_scaling={"type": "mrope", "mrope_section": [1, 1, 2]}),
        vision_config={"depth": 1, "hidden_size": 16}),
    "qwen3_moe": dict(
        _COMMON, model_type="qwen3_moe", intermediate_size=64,
        moe_intermediate_size=16, num_hidden_layers=3, num_experts=8,
        num_experts_per_tok=2, decoder_sparse_step=1, mlp_only_layers=[0],
        norm_topk_prob=True),
}
#: the families whose layers route tokens to experts
MOE_FAMILIES = ("gpt_oss", "deepseek_v2", "deepseek_v2_group", "deepseek_v3",
                "kimi_k2", "glm4_moe", "llama4", "qwen3_next",
                "longcat_flash", "qwen3_moe")

#: kinds: weight (a product's matrix), embed, bias, norm1 (a norm's scale
#: around 1), norm0 (a zero-centred norm's), sinks, a_log, conv
Shapes = Dict[str, Tuple[Tuple[int, ...], str]]


def _mlp(prefix: str, h: int, inter: int, fused: bool = False) -> Shapes:
    if fused:
        return {f"{prefix}.gate_up_proj.weight": ((2 * inter, h), "weight"),
                f"{prefix}.down_proj.weight": ((h, inter), "weight")}
    return {f"{prefix}.gate_proj.weight": ((inter, h), "weight"),
            f"{prefix}.up_proj.weight": ((inter, h), "weight"),
            f"{prefix}.down_proj.weight": ((h, inter), "weight")}


def _mla(tc: TargetConfig, ap: str) -> Shapes:
    h, heads = tc.hidden_size, tc.num_attention_heads
    qk = tc.qk_nope_head_dim + tc.qk_rope_head_dim
    out: Shapes = {}
    if tc.q_lora_rank:
        out[f"{ap}.q_a_proj.weight"] = ((tc.q_lora_rank, h), "weight")
        out[f"{ap}.q_a_layernorm.weight"] = ((tc.q_lora_rank,), "norm1")
        out[f"{ap}.q_b_proj.weight"] = ((heads * qk, tc.q_lora_rank),
                                        "weight")
    else:
        out[f"{ap}.q_proj.weight"] = ((heads * qk, h), "weight")
    out.update({
        f"{ap}.kv_a_proj_with_mqa.weight": (
            (tc.kv_lora_rank + tc.qk_rope_head_dim, h), "weight"),
        f"{ap}.kv_a_layernorm.weight": ((tc.kv_lora_rank,), "norm1"),
        f"{ap}.kv_b_proj.weight": (
            (heads * (tc.qk_nope_head_dim + tc.v_head_dim), tc.kv_lora_rank),
            "weight"),
        f"{ap}.o_proj.weight": ((h, heads * tc.v_head_dim), "weight"),
    })
    return out


def _std_attention(tc: TargetConfig, raw: dict, ap: str, norm: str
                   ) -> Shapes:
    h, d = tc.hidden_size, tc.resolved_head_dim
    heads, kvh = tc.num_attention_heads, tc.num_key_value_heads
    out: Shapes = {}
    if tc.model_type == "phi3":
        out[f"{ap}.qkv_proj.weight"] = (((heads + 2 * kvh) * d, h), "weight")
    else:
        q_rows = heads * d * (2 if tc.attn_output_gate else 1)
        out[f"{ap}.q_proj.weight"] = ((q_rows, h), "weight")
        out[f"{ap}.k_proj.weight"] = ((kvh * d, h), "weight")
        out[f"{ap}.v_proj.weight"] = ((kvh * d, h), "weight")
        if raw.get("attention_bias"):
            out[f"{ap}.q_proj.bias"] = ((q_rows,), "bias")
            out[f"{ap}.k_proj.bias"] = ((kvh * d,), "bias")
            out[f"{ap}.v_proj.bias"] = ((kvh * d,), "bias")
    out[f"{ap}.o_proj.weight"] = ((h, heads * d), "weight")
    if tc.qk_norm or tc.norm_style == "gemma":
        out[f"{ap}.q_norm.weight"] = ((d,), norm)
        out[f"{ap}.k_norm.weight"] = ((d,), norm)
    if tc.attention_sinks:
        out[f"{ap}.sinks"] = ((heads,), "sinks")
    return out


def _gdn(tc: TargetConfig, ap: str) -> Shapes:
    h = tc.hidden_size
    nk, nv = tc.linear_num_key_heads, tc.linear_num_value_heads
    dk, dv = tc.linear_key_head_dim, tc.linear_value_head_dim
    r = nv // nk
    conv = 2 * nk * dk + nv * dv
    return {
        f"{ap}.in_proj_qkvz.weight": ((nk * (2 * dk + 2 * r * dv), h),
                                      "weight"),
        f"{ap}.in_proj_ba.weight": ((nk * 2 * r, h), "weight"),
        f"{ap}.conv1d.weight": ((conv, 1, tc.linear_conv_kernel_dim),
                                "conv"),
        f"{ap}.A_log": ((nv,), "a_log"),
        f"{ap}.dt_bias": ((nv,), "bias"),
        f"{ap}.norm.weight": ((dv,), "norm1"),
        f"{ap}.out_proj.weight": ((h, nv * dv), "weight"),
    }


def _moe(tc: TargetConfig, raw: dict, p: str) -> Shapes:
    h, e = tc.hidden_size, tc.num_experts
    inter = tc.moe_intermediate_size
    out: Shapes = {}
    if tc.moe_variant == "gptoss":
        ep = f"{p}.mlp.experts"
        return {f"{p}.mlp.router.weight": ((e, h), "weight"),
                f"{p}.mlp.router.bias": ((e,), "bias"),
                f"{ep}.gate_up_proj": ((e, h, 2 * inter), "weight"),
                f"{ep}.gate_up_proj_bias": ((e, 2 * inter), "bias"),
                f"{ep}.down_proj": ((e, inter, h), "weight"),
                f"{ep}.down_proj_bias": ((e, h), "bias")}
    if tc.moe_variant == "llama4":
        fp = f"{p}.feed_forward"
        inter = tc.intermediate_size
        return {f"{fp}.router.weight": ((e, h), "weight"),
                f"{fp}.experts.gate_up_proj": ((e, h, 2 * inter), "weight"),
                f"{fp}.experts.down_proj": ((e, inter, h), "weight"),
                **_mlp(f"{fp}.shared_expert", h, inter)}
    if tc.moe_variant == "longcat":
        rp = f"{p}.mlp.router"
        routes = e + tc.zero_expert_num
        out[f"{rp}.classifier.weight"] = ((routes, h), "weight")
        if tc.router_bias:
            out[f"{rp}.classifier.bias"] = ((routes,), "bias")
        out[f"{rp}.e_score_correction_bias"] = ((routes,), "bias")
    else:
        out[f"{p}.mlp.gate.weight"] = ((e, h), "weight")
    if tc.moe_variant == "deepseek" and tc.topk_method == "noaux_tc":
        out[f"{p}.mlp.gate.e_score_correction_bias"] = ((e,), "bias")
    for j in range(e):
        out.update(_mlp(f"{p}.mlp.experts.{j}", h, inter))
    if tc.n_shared_experts:
        out.update(_mlp(f"{p}.mlp.shared_experts", h,
                        inter * tc.n_shared_experts))
    if tc.shared_expert_gated:
        out.update(_mlp(f"{p}.mlp.shared_expert", h,
                        raw["shared_expert_intermediate_size"]))
        out[f"{p}.mlp.shared_expert_gate.weight"] = ((1, h), "weight")
    return out


def tensor_shapes(tc: TargetConfig, raw: dict) -> Shapes:
    """Every tensor of a checkpoint of ``tc`` (``raw``: its text config),
    in the order of the model: the embedding, head and final norm, then
    each layer's."""
    h = tc.hidden_size
    norm = "norm0" if tc.norm_style == "gemma" else "norm1"
    out: Shapes = {"model.embed_tokens.weight": ((tc.vocab_size, h), "embed")}
    if not tc.tie_word_embeddings:
        out["lm_head.weight"] = ((tc.vocab_size, h), "weight")
    out["model.norm.weight"] = ((h,), norm)
    for i in range(tc.num_hidden_layers):
        out.update(layer_shapes(tc, raw, i))
    return out


def layer_shapes(tc: TargetConfig, raw: dict, i: int) -> Shapes:
    """The tensors of decoder layer ``i``."""
    h = tc.hidden_size
    norm = "norm0" if tc.norm_style == "gemma" else "norm1"
    p = f"model.layers.{i}"
    out: Shapes = {}
    if tc.dual_sublayer:
        for j in (0, 1):
            out[f"{p}.input_layernorm.{j}.weight"] = ((h,), norm)
            out[f"{p}.post_attention_layernorm.{j}.weight"] = ((h,), norm)
            out.update(_mla(tc, f"{p}.self_attn.{j}"))
            out.update(_mlp(f"{p}.mlps.{j}", h, tc.intermediate_size))
        out.update(_moe(tc, raw, p))
        return out
    names = ["input_layernorm", "post_attention_layernorm"]
    if tc.sandwich_norms:
        names += ["pre_feedforward_layernorm", "post_feedforward_layernorm"]
    out.update({f"{p}.{n}.weight": ((h,), norm) for n in names})
    if tc.layer_kind(i) == "linear_attention":
        out.update(_gdn(tc, f"{p}.linear_attn"))
    elif tc.attn_variant == "mla":
        out.update(_mla(tc, f"{p}.self_attn"))
    else:
        out.update(_std_attention(tc, raw, f"{p}.self_attn", norm))
    if tc.is_moe_layer(i):
        out.update(_moe(tc, raw, p))
    elif tc.moe_variant == "llama4":
        out.update(_mlp(f"{p}.feed_forward", h, tc.intermediate_size_mlp))
    else:
        out.update(_mlp(f"{p}.mlp", h, tc.intermediate_size,
                        fused=tc.model_type == "phi3"))
    return out


def numpy_value(rng: np.random.Generator, shape, kind: str) -> np.ndarray:
    """A tiny checkpoint's value of one tensor, from ``rng``."""
    if kind == "embed":
        x = rng.normal(size=shape)
    elif kind == "weight":
        x = rng.normal(size=shape) * 0.15
    elif kind == "norm1":
        x = 1.0 + rng.normal(size=shape) * 0.1
    elif kind in ("norm0", "bias"):
        x = rng.normal(size=shape) * 0.1
    elif kind == "sinks":
        x = rng.normal(size=shape)
    elif kind == "a_log":
        x = np.log(rng.uniform(1.0, 4.0, size=shape))
    elif kind == "conv":
        x = rng.normal(size=shape) * 0.3
    else:
        raise ValueError(kind)
    return x.astype(np.float32)


def write_family_target(root, family: str, seed: int = 0, **overrides
                        ) -> str:
    """``TINY_FAMILIES[family]`` (with ``overrides``) as an HF directory
    (``config.json`` and one fp32 ``model.safetensors`` from ``seed``). The
    VL composite keeps its text tower under ``model.language_model.*``
    beside a vision tower."""
    root = str(root)
    os.makedirs(root, exist_ok=True)
    raw = dict(TINY_FAMILIES[family], **overrides)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(raw, f)
    tc = TargetConfig.from_file(root)
    rng = np.random.default_rng(seed)
    tensors = {key: torch.from_numpy(numpy_value(rng, shape, kind))
               for key, (shape, kind) in tensor_shapes(
                   tc, raw.get("text_config", raw)).items()}
    if tc.model_type in ("qwen2_5_vl_text", "qwen2_vl_text"):
        tensors = {("model.language_model." + k[len("model."):]
                    if k.startswith("model.") else k): v
                   for k, v in tensors.items()}
        tensors["model.visual.patch_embed.proj.weight"] = torch.from_numpy(
            numpy_value(rng, (16, 3, 2, 2), "weight"))
    save_feature_file(os.path.join(root, "model.safetensors"), tensors)
    return root
