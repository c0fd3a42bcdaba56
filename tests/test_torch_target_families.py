"""The port's capture forward on the target families beside the dense ones
and the MoE routers, against the JAX package, on the CPU.

``TargetConfig.from_file`` gives JAX's fields, field for field, for every
``model_type`` branch (the VL composite and flat configs, llama4's eps
default, longcat's logical layers); the loader reads a VL composite
checkpoint's text tower as JAX's does; ``target_capture_forward`` of
gemma3 (sandwich norms, sliding layers with their own rope base, the
softcap), phi3 (fused projections, partial rotary), gpt-oss (sinks,
sliding layers, the clamped SwiGLU experts), llama4 (chunked attention
below S, NoPE layers with temperature tuning, input-scaled experts),
qwen3_next (gated DeltaNet and gated attention) and the Qwen2.5-VL text
tower (also on explicit [3, B, S] positions and on ``inputs_embeds``)
equals JAX's in fp32 at ``tests/test_target_transformer.py``'s 2e-4, with
right padding and capture layers -1 and the last; the MoE families with
both ``moe_impl`` values; and the chunked gated delta rule equals JAX's
and does not depend on its chunk size. The checkpoints are written from a
numpy seed by the port's writer (``tests/_torch_targets.py``)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.models.target import transformer as jax_tf
from specforge_tpu_torch.models.target import transformer as pt_tf
from tests._torch_targets import (
    MOE_FAMILIES,
    TINY_FAMILIES,
    V,
    write_family_target,
)

TOL = 2e-4  # tests/test_target_transformer.py:88-92
B, S = 2, 12
FAMILIES = ("gemma3", "phi3", "gpt_oss", "llama4", "qwen3_next",
            "qwen2_5_vl")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per worker: several pytest workers share
    the machine in the tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def both_configs(root):
    jcfg = jax_tf.TargetConfig.from_file(root)
    pcfg = pt_tf.TargetConfig.from_file(root)
    return jcfg, pcfg


def both_params(root, dtype="float32"):
    jcfg, pcfg = both_configs(root)
    jparams = jax_tf.load_target_params(root, jcfg, dtype=getattr(jnp, dtype))
    pparams = pt_tf.load_target_params(root, pcfg, dtype=getattr(torch, dtype),
                                       device="cpu")
    return jcfg, jparams, pcfg, pparams


def assert_same_fields(jcfg, pcfg):
    """Every field of JAX's config on the port's, equal (``attention_bias``
    is JAX's only: no code reads it)."""
    want = dataclasses.asdict(jcfg)
    want.pop("attention_bias")
    assert dataclasses.asdict(pcfg) == want
    for i in range(pcfg.num_hidden_layers):
        assert pcfg.layer_kind(i) == jcfg.layer_kind(i)
        assert pcfg.is_moe_layer(i) == jcfg.is_moe_layer(i)
    assert pcfg.mrope_section == jcfg.mrope_section


#: config variants beside ``TINY_FAMILIES``: the other spellings of a
#: family and the defaults each branch fills in
CONFIG_VARIANTS = {
    "gemma3_composite": {"model_type": "gemma3", "text_config": dict(
        TINY_FAMILIES["gemma3"], model_type="gemma3_text")},
    "gemma3_defaults": {k: v for k, v in TINY_FAMILIES["gemma3"].items()
                        if k not in ("query_pre_attn_scalar", "layer_types",
                                     "hidden_activation")},
    "qwen2_5_vl_flat": dict(TINY_FAMILIES["qwen2_5_vl"]["text_config"],
                            model_type="qwen2_5_vl"),
    "qwen2_vl_flat": dict(TINY_FAMILIES["qwen2_5_vl"]["text_config"],
                          model_type="qwen2_vl"),
    "qwen2_5_vl_nested": {"model_type": "qwen2_5_vl", "text_config": dict(
        TINY_FAMILIES["qwen2_5_vl"]["text_config"], model_type="qwen2_5_vl")},
    "llama4_defaults": {k: v for k, v in TINY_FAMILIES["llama4"].items()
                        if k not in ("interleave_moe_layer_step",
                                     "no_rope_layer_interval",
                                     "attention_chunk_size")},
    "llama4_lists": dict(TINY_FAMILIES["llama4"], model_type="llama4",
                         no_rope_layers=[1, 1, 0, 1], moe_layers=[0, 3],
                         rms_norm_eps=1e-6),
    "deepseek_v3_defaults": {k: v for k, v in
                             TINY_FAMILIES["deepseek_v3"].items()
                             if k not in ("n_group", "topk_group")},
    "deepseek_v2_norm": dict(TINY_FAMILIES["deepseek_v2"],
                             norm_topk_prob=True, scoring_func="sigmoid"),
    "qwen3_next_defaults": {k: v for k, v in
                            TINY_FAMILIES["qwen3_next"].items()
                            if not k.startswith("linear_")},
    "gpt_oss_no_layer_types": {k: v for k, v in
                               TINY_FAMILIES["gpt_oss"].items()
                               if k != "layer_types"},
    "qwen3": dict(TINY_FAMILIES["qwen3_moe"], model_type="qwen3",
                  num_experts=0),
    "qwen2": dict(TINY_FAMILIES["phi3"], model_type="qwen2"),
    "llama": {k: v for k, v in TINY_FAMILIES["phi3"].items()
              if k != "model_type"},
    "mup": dict(TINY_FAMILIES["phi3"], model_type="llama",
                logits_mup_width_multiplier=0.5),
}


@pytest.mark.parametrize("name", [*TINY_FAMILIES, *CONFIG_VARIANTS])
def test_from_file_matches_jax(tmp_path, name):
    raw = TINY_FAMILIES.get(name) or CONFIG_VARIANTS[name]
    (tmp_path / "config.json").write_text(json.dumps(raw))
    jcfg, pcfg = both_configs(str(tmp_path))
    assert_same_fields(jcfg, pcfg)
    if name == "llama4_defaults":
        assert pcfg.rms_norm_eps == 1e-5
    if name == "longcat_flash":
        assert pcfg.num_hidden_layers == raw["num_layers"] == 2


def test_loader_reads_the_vl_text_tower_as_jax_does(tmp_path):
    """A composite checkpoint: ``model.language_model.*`` read as
    ``model.*``, ``model.visual.*`` skipped, the same tensors bit for bit
    in bf16 as JAX's loader."""
    root = write_family_target(tmp_path, "qwen2_5_vl")
    from specforge_tpu_torch.runtime.data_plane.feature_file import (
        read_safetensors_keys,
    )
    keys = read_safetensors_keys(os.path.join(root, "model.safetensors"))
    assert any(k.startswith("model.language_model.") for k in keys)
    assert any(k.startswith("model.visual.") for k in keys)
    _, jparams, pcfg, pparams = both_params(root, "bfloat16")
    assert pcfg.model_type == "qwen2_5_vl_text"
    assert set(pparams) == set(jparams)
    assert not any("visual" in k or "language_model" in k for k in pparams)
    for key, value in jparams.items():
        np.testing.assert_array_equal(
            pparams[key].float().numpy(), np.asarray(value, np.float32),
            err_msg=key)


@pytest.fixture(scope="module")
def family_targets(tmp_path_factory):
    """Each family's tiny checkpoint and both packages' fp32 params, made
    once for the module."""
    cache = {}

    def get(family):
        if family not in cache:
            root = write_family_target(tmp_path_factory.mktemp(family),
                                       family, seed=1)
            cache[family] = both_params(root)
        return cache[family]

    return get


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, size=(B, S))
    mask = np.ones((B, S), np.int64)
    mask[1, 9:] = 0
    return ids, mask


def assert_forward_matches(family_targets, family, impl, **kwargs):
    """The port's fp32 forward against JAX's over the real tokens, at
    capture layers -1, 1 and the last."""
    jcfg, jparams, pcfg, pparams = family_targets(family)
    assert_same_fields(jcfg, pcfg)
    ids, mask = inputs()
    layers = (-1, 1, pcfg.num_hidden_layers - 1)
    jax_kwargs = {k: jnp.asarray(v) for k, v in kwargs.items()}
    aux_j, last_j, _ = jax_tf.target_capture_forward(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), layers,
        **jax_kwargs)
    aux_p, last_p = pt_tf.target_capture_forward(
        pparams, pcfg, torch.as_tensor(ids), torch.as_tensor(mask), layers,
        moe_impl=impl, **{k: torch.as_tensor(v) for k, v in kwargs.items()})
    valid = mask.astype(bool)
    np.testing.assert_allclose(aux_p.numpy()[valid], np.asarray(aux_j)[valid],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(last_p.numpy()[valid],
                               np.asarray(last_j)[valid], rtol=TOL, atol=TOL)
    return aux_p, last_p


@pytest.mark.parametrize("family,impl", [
    (f, impl) for f in FAMILIES
    for impl in (("gathered", "dense") if f in MOE_FAMILIES else
                 ("gathered",))])
def test_capture_forward_matches_jax(family_targets, family, impl):
    assert_forward_matches(family_targets, family, impl)
    pcfg = family_targets(family)[2]
    if family == "llama4":  # every llama4 branch is reached
        assert S > pcfg.attention_chunk_size
        assert pcfg.no_rope_layers == (1, 0, 1, 0)
        assert pcfg.qk_l2_norm and pcfg.attn_temperature_tuning
    if family == "gemma3":
        assert {"sliding_attention", "full_attention"} <= set(
            pcfg.layer_types)
    if family == "qwen3_next":
        assert {"linear_attention", "full_attention"} <= set(
            pcfg.layer_types)


def test_vl_text_tower_positions_and_embeddings(family_targets):
    """Explicit [3, B, S] positions (a vision span at 4:8) and
    ``inputs_embeds`` (the multimodal seam) against JAX's; [B, S]
    positions equal the default text positions."""
    _, jparams, pcfg, pparams = family_targets("qwen2_5_vl")
    pos = np.broadcast_to(np.arange(S), (3, B, S)).copy()
    pos[1, :, 4:8] += 3
    pos[2, :, 4:8] += 5
    assert_forward_matches(family_targets, "qwen2_5_vl", "gathered",
                           position_ids=pos)
    rng = np.random.default_rng(4)
    embeds = rng.normal(size=(B, S, pcfg.hidden_size)).astype(np.float32)
    aux, _ = assert_forward_matches(family_targets, "qwen2_5_vl", "gathered",
                                    position_ids=pos, inputs_embeds=embeds)
    np.testing.assert_array_equal(aux[..., :pcfg.hidden_size].numpy(),
                                  embeds)
    ids, mask = inputs()
    plain = pt_tf.target_capture_forward(
        pparams, pcfg, torch.as_tensor(ids), None, (0, 1))
    text = pt_tf.target_capture_forward(
        pparams, pcfg, torch.as_tensor(ids), None, (0, 1),
        position_ids=torch.arange(S)[None].expand(B, S))
    for a, b in zip(plain, text):
        assert torch.equal(a, b)


def delta_rule_inputs(seed=5, b=2, s=13, h=3, dk=8, dv=8):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, dk)).astype(np.float32),
            rng.normal(size=(b, s, h, dk)).astype(np.float32),
            rng.normal(size=(b, s, h, dv)).astype(np.float32),
            -np.abs(rng.normal(size=(b, s, h))).astype(np.float32),
            (1.0 / (1.0 + np.exp(-rng.normal(size=(b, s, h))))).astype(
                np.float32)]


@pytest.mark.parametrize("chunk", [4, 64])
def test_chunk_gated_delta_rule_matches_jax(chunk):
    """The port's loop over chunks against JAX's scan, several chunks and
    one, and each chunk size against one chunk (the rule is exact for any
    chunk size: ``tests/test_target_families.py``'s 2e-5)."""
    args = delta_rule_inputs()
    ref = jax_tf._chunk_gated_delta_rule(*map(jnp.asarray, args),
                                         chunk_size=chunk)
    got = pt_tf._chunk_gated_delta_rule(*map(torch.as_tensor, args),
                                        chunk_size=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    whole = pt_tf._chunk_gated_delta_rule(*map(torch.as_tensor, args),
                                          chunk_size=64)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=2e-5,
                               atol=2e-5)
