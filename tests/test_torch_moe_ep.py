"""The port's expert-parallel MoE layer against the JAX package's, in one
process on the CPU.

Each rank's contribution (``_moe_ep_partial`` on that rank's experts,
``stack_moe_expert_params`` with its mesh) is computed here and the
contributions summed, as the ranks' all-reduce sums them; deepseek's shared
experts are added after, as ``_moe_ep`` adds them. The sum is held against
JAX's ``_moe_mlp_ep`` on the 8-virtual-device mesh for every case of
``tests/test_moe_ep.py``, at its 2e-4, with the same overflow count;
``stack_moe_expert_params`` against JAX's key for key and shape for shape,
with its divisibility error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.models.target import transformer as jax_tf
from specforge_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from specforge_tpu.parallel.mesh import build_mesh as jax_build_mesh
from specforge_tpu_torch.models.target import transformer as pt_tf
from specforge_tpu_torch.models.target.sharding import (
    stack_moe_expert_params,
)
from specforge_tpu_torch.parallel.mesh import Mesh, MeshConfig

TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_moe_ep.py:70
PREFIX = "model.layers.0"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cfg_of(variant="qwen", e=8, k=2, h=32, inter=48):
    """``tests/test_moe_ep.py``'s ``_moe_cfg``, ``_deepseek_cfg`` and
    ``_gptoss_cfg`` → (JAX config, port config)."""
    fields = dict(vocab_size=1, hidden_size=h, intermediate_size=inter,
                  num_hidden_layers=1, num_attention_heads=1,
                  num_key_value_heads=1, num_experts=e,
                  num_experts_per_tok=k, moe_intermediate_size=inter)
    fields.update({
        "qwen": dict(norm_topk_prob=True),
        "deepseek": dict(moe_variant="deepseek", scoring_func="sigmoid",
                         topk_method="noaux_tc", n_group=4, topk_group=2,
                         norm_topk_prob=True, routed_scaling_factor=2.5,
                         n_shared_experts=1),
        "gptoss": dict(moe_variant="gptoss", hidden_act="silu"),
    }[variant])
    return jax_tf.TargetConfig(**fields), pt_tf.TargetConfig(**fields)


def params_of(cfg, rng):
    """The numpy weights of ``tests/test_moe_ep.py``'s helpers."""
    e, h, inter = cfg.num_experts, cfg.hidden_size, cfg.moe_intermediate_size
    f32 = np.float32
    if cfg.moe_variant == "gptoss":
        return {
            f"{PREFIX}.mlp.router.weight": rng.normal(size=(e, h)).astype(f32),
            f"{PREFIX}.mlp.router.bias": rng.normal(size=(e,)).astype(f32)
            * 0.1,
            f"{PREFIX}.mlp.experts.gate_up_proj": rng.normal(
                size=(e, h, 2 * inter)).astype(f32) * 0.1,
            f"{PREFIX}.mlp.experts.gate_up_proj_bias": rng.normal(
                size=(e, 2 * inter)).astype(f32) * 0.1,
            f"{PREFIX}.mlp.experts.down_proj": rng.normal(
                size=(e, inter, h)).astype(f32) * 0.1,
            f"{PREFIX}.mlp.experts.down_proj_bias": rng.normal(
                size=(e, h)).astype(f32) * 0.1,
        }
    params = {f"{PREFIX}.mlp.gate.weight": rng.normal(size=(e, h)).astype(f32)}
    for i in range(e):
        for name, shape in (("gate_proj", (inter, h)), ("up_proj", (inter, h)),
                            ("down_proj", (h, inter))):
            params[f"{PREFIX}.mlp.experts.{i}.{name}.weight"] = rng.normal(
                size=shape).astype(f32) * 0.1
    if cfg.moe_variant == "deepseek":
        params[f"{PREFIX}.mlp.gate.e_score_correction_bias"] = rng.normal(
            size=(e,)).astype(f32) * 0.2
        for name, shape in (("gate_proj", (inter, h)), ("up_proj", (inter, h)),
                            ("down_proj", (h, inter))):
            params[f"{PREFIX}.mlp.shared_experts.{name}.weight"] = rng.normal(
                size=shape).astype(f32) * 0.1
    return params


def jax_ep(cfg, params, y, ep, factor=None, valid=None):
    mesh = jax_build_mesh(JaxMeshConfig(fsdp=ep, dp=8 // ep),
                          devices=jax.devices()[:8])
    stacked = jax_tf.stack_moe_expert_params(
        {k: jnp.asarray(v) for k, v in params.items()}, cfg, mesh)
    out, overflow = jax.jit(lambda p, yv, v: jax_tf._moe_mlp_ep(
        p, cfg, PREFIX, yv, mesh, capacity_factor=factor, token_valid=v))(
        stacked, jnp.asarray(y), None if valid is None else jnp.asarray(valid))
    return np.asarray(out), int(overflow)


def port_ep(cfg, params, y, ep, factor=None, valid=None):
    """Σ over the ranks of their contributions, then the shared experts →
    (out, overflow as every rank counts it)."""
    whole = {k: torch.from_numpy(v) for k, v in params.items()}
    yt = torch.from_numpy(y)
    total, overflows = 0, set()
    for rank in range(ep):
        mesh = Mesh(MeshConfig(fsdp=ep), rank, CPU, "local")
        out, _, overflow = pt_tf._moe_ep_partial(
            stack_moe_expert_params(whole, cfg, mesh), cfg, PREFIX, yt, ep,
            rank, factor, None if valid is None else torch.from_numpy(valid))
        total = total + out
        overflows.add(overflow)
    assert len(overflows) == 1  # the same count on every rank
    out = total.reshape(yt.shape)
    if cfg.moe_variant == "deepseek" and cfg.n_shared_experts:
        out = out + pt_tf._dense_mlp(whole, cfg,
                                     f"{PREFIX}.mlp.shared_experts", yt)
    return out.numpy(), overflows.pop()


def skewed(params, variant):
    """Every token's routing pulled to one expert (group)."""
    gate = params[f"{PREFIX}.mlp.gate.weight"]
    if variant == "qwen":
        gate[:] = 0.0
        gate[0] = 10.0
    else:
        gate[0] += 10.0


CASES = {
    # name: (variant, experts, ep, seed, tokens, factor, skewed routing)
    "e8_ep8": ("qwen", 8, 8, 0, 24, None, False),
    "e16_ep8": ("qwen", 16, 8, 0, 24, None, False),
    "e8_ep4": ("qwen", 8, 4, 0, 24, None, False),
    "balanced_cf2": ("qwen", 8, 8, 1, 64, 2.0, False),
    "skewed_cf1": ("qwen", 8, 8, 2, 64, 1.0, True),
    "deepseek": ("deepseek", 8, 8, 5, 24, None, False),
    "gptoss": ("gptoss", 8, 8, 6, 24, None, False),
    "deepseek_skewed_cf1": ("deepseek", 8, 8, 7, 64, 1.0, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ep_matches_jax(case):
    variant, e, ep, seed, s, factor, skew = CASES[case]
    jcfg, pcfg = cfg_of(variant, e=e)
    rng = np.random.default_rng(seed)
    params = params_of(jcfg, rng)
    y = rng.normal(size=(2, s, 32)).astype(np.float32)
    if skew:
        skewed(params, variant)
        if variant == "qwen":
            y = np.abs(y)
    got, got_overflow = port_ep(pcfg, params, y, ep, factor)
    want, want_overflow = jax_ep(jcfg, params, y, ep, factor)
    assert got_overflow == want_overflow
    # the same rows computed, the same dropped
    np.testing.assert_allclose(got, want, **TOL)
    if skew:
        assert got_overflow > 0
        return
    assert got_overflow == 0
    # and the port's own gathered path
    whole = {k: torch.from_numpy(v) for k, v in params.items()}
    ref, _ = pt_tf._MOE[variant](whole, pcfg, PREFIX, torch.from_numpy(y),
                                 "gathered")
    np.testing.assert_allclose(got, ref.numpy(), **TOL)


def test_ep_padding_consumes_no_capacity():
    """A mostly padded batch under a bounded factor does not overflow: the
    padding joins no group; the real rows match JAX's and the padded ones
    are exactly 0 (``tests/test_moe_ep.py:154``)."""
    jcfg, pcfg = cfg_of("qwen")
    rng = np.random.default_rng(3)
    params = params_of(jcfg, rng)
    y = rng.normal(size=(4, 32, 32)).astype(np.float32)
    valid = np.zeros((4, 32), np.int32)
    valid[0, :8] = 1
    got, got_overflow = port_ep(pcfg, params, y, 8, 2.0, valid)
    want, want_overflow = jax_ep(jcfg, params, y, 8, 2.0, valid)
    assert got_overflow == want_overflow == 0
    np.testing.assert_allclose(got[0, :8], want[0, :8], **TOL)
    assert np.all(got[1:] == 0.0) and np.all(want[1:] == 0.0)


@pytest.mark.parametrize("variant", ["qwen", "gptoss"])
def test_stack_moe_expert_params_matches_jax(variant):
    """Keys and shapes of the stacked tables against JAX's (one process:
    every expert; on a mesh each rank's E/ep of them, JAX's global shape
    cut on the expert dimension), idempotence, and JAX's error for experts
    that do not divide."""
    jcfg, pcfg = cfg_of(variant)
    params = params_of(jcfg, np.random.default_rng(0))
    whole = {k: torch.from_numpy(v) for k, v in params.items()}
    want = jax_tf.stack_moe_expert_params(
        {k: jnp.asarray(v) for k, v in params.items()}, jcfg)
    got = stack_moe_expert_params(whole, pcfg)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value))
    again = stack_moe_expert_params(got, pcfg)
    assert all(again[k] is got[k] for k in got)
    mesh = Mesh(MeshConfig(fsdp=4), 2, CPU, "local")
    local = stack_moe_expert_params(whole, pcfg, mesh)
    assert set(local) == set(want)
    for key, value in want.items():
        if ".experts." in key:
            np.testing.assert_array_equal(local[key].numpy(),
                                          np.asarray(value)[4:6])
    local_again = stack_moe_expert_params(local, pcfg, mesh)
    assert all(torch.equal(local_again[k], local[k]) for k in local)
    odd = Mesh(MeshConfig(fsdp=3), 0, CPU, "local")
    with pytest.raises(ValueError, match="num_experts=8 not divisible by "
                                         "fsdp=3"):
        stack_moe_expert_params(whole, pcfg, odd)
    with pytest.raises(ValueError, match="num_experts=8 not divisible by "
                                         "fsdp=3"):
        jax_tf.stack_moe_expert_params(
            {k: jnp.asarray(v) for k, v in params.items()}, jcfg,
            jax_build_mesh(JaxMeshConfig(fsdp=3), devices=jax.devices()[:3]))


def test_ep_capture_forward_in_one_process(tmp_path):
    """``target_capture_forward(moe_impl="ep")`` on a one-rank mesh equals
    the gathered capture (every expert, full capacity) bit for bit, and a
    factor that overflows reports JAX's count through ``stats``."""
    from tests._torch_targets import write_family_target

    root = write_family_target(tmp_path / "t", "qwen3_moe", seed=1)
    tc = pt_tf.TargetConfig.from_file(root)
    whole = pt_tf.load_target_params(root, tc, torch.float32, "cpu")
    mesh = Mesh(MeshConfig(fsdp=1), 0, CPU, "local")
    stacked = stack_moe_expert_params(whole, tc, mesh)
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, tc.vocab_size, (2, 16)))
    mask = torch.ones_like(ids)
    ref = pt_tf.target_capture_forward(whole, tc, ids, mask, (0, 1))
    stats = {}
    got = pt_tf.target_capture_forward(stacked, tc, ids, mask, (0, 1),
                                       moe_impl="ep", mesh=mesh, stats=stats)
    assert stats["moe_overflow"] == 0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    pt_tf.target_capture_forward(stacked, tc, ids, mask, (0, 1),
                                 moe_impl="ep", mesh=mesh,
                                 moe_capacity_factor=0.25, stats=stats)
    jcfg = jax_tf.TargetConfig.from_file(root)
    jparams = jax_tf.load_target_params(root, jcfg, dtype=jnp.float32)
    jmesh = jax_build_mesh(JaxMeshConfig(fsdp=1, dp=8),
                           devices=jax.devices()[:8])
    _, _, overflow = jax.jit(lambda p, i, m: jax_tf.target_capture_forward(
        p, jcfg, i, m, (0, 1), moe_impl="ep", moe_mesh=jmesh,
        moe_capacity_factor=0.25))(
        jax_tf.stack_moe_expert_params(jparams, jcfg, jmesh),
        jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()))
    assert stats["moe_overflow"] == int(overflow) > 0

