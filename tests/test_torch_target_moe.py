"""The port's MoE and MLA targets against the JAX package, on the CPU.

``target_capture_forward`` of deepseek_v2 (greedy routing, and
group-limited with a q LoRA), deepseek_v3 (noaux_tc, sigmoid scores, the
correction bias, q LoRA, yarn's mscale² in the softmax scale), kimi_k2,
glm4_moe (partial rotary, qk norms, biases), longcat_flash (dual
sublayers, zero experts) and qwen3_moe equals JAX's in fp32 at 2e-4 with
both ``moe_impl`` values (``gathered`` and ``dense``), with right padding
and capture layers -1 and the last; every router's top-k ids and weights
equal JAX's on the same inputs, ties included; the experts are combined
without atomics, two runs are bit-identical and both impls route alike;
the capture runner's files of an MoE target match the JAX runner's; the
entry point takes ``--moe-impl dense|gathered``; and a longcat target's
capture layers follow its logical layers. The checkpoints are written
from a numpy seed by the port's writer (``tests/_torch_targets.py``)."""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.models.target import transformer as jax_tf
from specforge_tpu.offline_capture.capture import (
    OfflineCaptureConfig as JaxCaptureConfig,
)
from specforge_tpu.offline_capture.capture import (
    OfflineCaptureRunner as JaxCaptureRunner,
)
from specforge_tpu.runtime.data_plane import feature_file as jax_ff
from specforge_tpu_torch.models.target import transformer as pt_tf
from specforge_tpu_torch.offline_capture import prepare
from specforge_tpu_torch.offline_capture.capture import (
    OfflineCaptureConfig,
    OfflineCaptureRunner,
)
from specforge_tpu_torch.runtime.data_plane import feature_file as pt_ff
from tests._torch_targets import H, V, write_family_target
from tests.test_torch_target_families import (
    assert_forward_matches,
    both_params,
    family_targets,  # noqa: F401  (a fixture)
    inputs,
    one_torch_thread,  # noqa: F401  (an autouse fixture)
)

TOL = 2e-4
FAMILIES = ("deepseek_v2", "deepseek_v2_group", "deepseek_v3", "kimi_k2",
            "glm4_moe", "longcat_flash", "qwen3_moe")


@pytest.mark.parametrize("impl", ["gathered", "dense"])
@pytest.mark.parametrize("family", FAMILIES)
def test_capture_forward_matches_jax(family_targets, family, impl):
    assert_forward_matches(family_targets, family, impl)
    pcfg = family_targets(family)[2]
    if family.startswith("deepseek") or family == "kimi_k2":
        assert pcfg.attn_variant == "mla"
        assert pcfg.v_head_dim != pcfg.qk_nope_head_dim + pcfg.qk_rope_head_dim
    if family == "deepseek_v3":
        assert pcfg.mla_logit_mscale and pcfg.rope_scaling["mscale_all_dim"]


def route_config(**kw):
    """The same router settings in both packages' configs."""
    fields = dict(vocab_size=1, hidden_size=H, intermediate_size=16,
                  num_hidden_layers=1, num_attention_heads=1,
                  num_key_value_heads=1, **kw)
    return jax_tf.TargetConfig(**fields), pt_tf.TargetConfig(**fields)


ROUTERS = {
    "qwen": dict(num_experts=8, num_experts_per_tok=2),
    "qwen_norm": dict(num_experts=8, num_experts_per_tok=3,
                      norm_topk_prob=True),
    "greedy": dict(moe_variant="deepseek", num_experts=8,
                   num_experts_per_tok=2, routed_scaling_factor=1.5),
    "group_limited": dict(moe_variant="deepseek", num_experts=8,
                          num_experts_per_tok=2, n_group=4, topk_group=2,
                          topk_method="group_limited_greedy"),
    "noaux_tc": dict(moe_variant="deepseek", num_experts=8,
                     num_experts_per_tok=2, n_group=4, topk_group=2,
                     topk_method="noaux_tc", scoring_func="sigmoid",
                     norm_topk_prob=True, routed_scaling_factor=2.5),
    # a correction bias far below the scores: outside its groups every
    # choice is the masked 0.0, so the top k tie among them
    "noaux_tc_ties": dict(moe_variant="deepseek", num_experts=8,
                          num_experts_per_tok=6, n_group=4, topk_group=1,
                          topk_method="noaux_tc", scoring_func="sigmoid"),
}


@pytest.mark.parametrize("name", list(ROUTERS))
def test_router_matches_jax(name):
    """The qwen and deepseek routers' top-k ids (in order) and weights
    against JAX's on the same fp32 inputs."""
    jcfg, pcfg = route_config(**ROUTERS[name])
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, H)).astype(np.float32)
    w = (rng.normal(size=(8, H)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(8,)) * 0.1).astype(np.float32)
    if name == "noaux_tc_ties":
        bias -= 10.0
    if pcfg.moe_variant == "qwen":
        ref = jax_tf._moe_route_w(jnp.asarray(w), jcfg, jnp.asarray(x))
        got = pt_tf._moe_route(torch.as_tensor(w), pcfg, torch.as_tensor(x))
    else:
        ref = jax_tf._deepseek_route_w(jnp.asarray(w), jnp.asarray(bias),
                                       jcfg, jnp.asarray(x))
        got = pt_tf._deepseek_route(torch.as_tensor(w),
                                    torch.as_tensor(bias), pcfg,
                                    torch.as_tensor(x))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-6,
                               atol=1e-7)


def test_topk_orders_ties_as_jax():
    """The gpt-oss, llama4 and longcat routers take the top k of their
    logits: ties go to the lower index, as ``lax.top_k`` gives them."""
    rng = np.random.default_rng(3)
    logits = rng.integers(-2, 3, size=(128, 8)).astype(np.float32)
    for k in (1, 2, 5):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(logits), k)
        got_v, got_i = pt_tf._topk(torch.as_tensor(logits), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))


def test_expert_mix_repeats_and_impls_route_alike(family_targets):
    """Two gathered runs are bit-identical; the dense run routes every
    token to the same experts (``routing``) and agrees within 2e-4; the
    module has no atomic accumulation."""
    _, _, pcfg, pparams = family_targets("deepseek_v3")
    ids, mask = (torch.as_tensor(a) for a in inputs())
    runs = []
    for impl in ("gathered", "gathered", "dense"):
        routing = {}
        out = pt_tf.target_capture_forward(pparams, pcfg, ids, mask, (0, 2),
                                           moe_impl=impl, routing=routing)
        runs.append((out, routing))
    (first, route1), (again, route2), (dense, route3) = runs
    assert sorted(route1) == [1, 2]  # the MoE layers (first_k_dense 1)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    for layer, ids1 in route1.items():
        assert torch.equal(ids1, route2[layer])
        assert torch.equal(ids1, route3[layer])
        assert ids1.shape == (ids.numel(), pcfg.num_experts_per_tok)
    for a, b in zip(first, dense):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)
    source = inspect.getsource(pt_tf)
    for atomic in ("index_add", "scatter_add", "accumulate=True",
                   "index_put"):
        assert atomic not in source


def test_moe_impl_refusals(family_targets):
    """JAX's refusals (``tests/test_moe_ep.py:192``,
    ``transformer.py:1719-1723``): EP without a mesh, and the llama4 and
    longcat variants under EP; an unknown impl. EP on a one-rank mesh runs:
    the gathered capture bit for bit."""
    from specforge_tpu_torch.models.target.sharding import (
        stack_moe_expert_params,
    )
    from specforge_tpu_torch.parallel.mesh import Mesh, MeshConfig

    _, _, pcfg, pparams = family_targets("qwen3_moe")
    ids, mask = (torch.as_tensor(a) for a in inputs())
    with pytest.raises(ValueError, match="requires a device mesh"):
        pt_tf.target_capture_forward(pparams, pcfg, ids, mask, (0,),
                                     moe_impl="ep")
    with pytest.raises(ValueError, match="unknown MoE impl 'ragged'"):
        pt_tf.target_capture_forward(pparams, pcfg, ids, mask, (0,),
                                     moe_impl="ragged")
    mesh = Mesh(MeshConfig(), 0, torch.device("cpu"), "local")
    for family in ("llama4", "longcat_flash"):
        _, _, cfg, params = family_targets(family)
        with pytest.raises(ValueError, match="moe_impl='ep' supports "
                                             "qwen/deepseek/gptoss MoE "
                                             f"targets .got '{cfg.moe_variant}'"):
            pt_tf.target_capture_forward(params, cfg, ids, mask, (0,),
                                         moe_impl="ep", mesh=mesh)
    stats = {}
    got = pt_tf.target_capture_forward(
        stack_moe_expert_params(pparams, pcfg, mesh), pcfg, ids, mask, (0,),
        moe_impl="ep", mesh=mesh, stats=stats)
    want = pt_tf.target_capture_forward(pparams, pcfg, ids, mask, (0,))
    assert stats["moe_overflow"] == 0
    valid = mask.bool()  # EP routes no padding token
    assert all(torch.equal(a[valid], b[valid]) for a, b in zip(got, want))


def samples(n, seed=0, lo=5, hi=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(lo, hi + 1))
        out.append({"input_ids": rng.integers(0, V, size=length),
                    "loss_mask": (rng.random(length) > 0.3).astype(np.int64)})
    return out


def test_moe_runner_files_match_jax(tmp_path):
    """Both runners over one deepseek_v2 checkpoint (fp32 weights and
    files, the gathered path on both sides): the same files, tensors
    within 2e-4, equal metadata."""
    root = write_family_target(tmp_path / "target", "deepseek_v2", seed=2)
    jcfg, jparams, pcfg, pparams = both_params(root)
    data = samples(5)
    layers = (0, 1, 2)
    out = {}
    for name, runner_cls, cfg_cls, kwargs in (
            ("jax", JaxCaptureRunner, JaxCaptureConfig,
             dict(target_config=jcfg, target_params=jparams)),
            ("port", OfflineCaptureRunner, OfflineCaptureConfig,
             dict(target_config=pcfg, target_params=pparams,
                  moe_impl="gathered"))):
        out[name] = str(tmp_path / name)
        config = cfg_cls(target_model_path=root, output_dir=out[name],
                         capture_layers=layers, max_length=12, batch_size=2,
                         layout="eagle", store_dtype="float32")
        runner_cls(config, **kwargs).run(data)
    for i, sample in enumerate(data):
        name = f"sample-{i:06d}.sft"
        mine, meta = pt_ff.load_feature_file(os.path.join(out["port"], name))
        ref, ref_meta = jax_ff.load_feature_file(os.path.join(out["jax"],
                                                              name))
        assert meta == ref_meta
        assert set(mine) == set(ref)
        assert mine["hidden_state"].shape == (len(sample["input_ids"]),
                                              3 * H)
        for key in mine:
            np.testing.assert_allclose(mine[key].numpy(), ref[key], rtol=TOL,
                                       atol=TOL, err_msg=key)


def test_prepare_takes_moe_impl(tmp_path):
    """``prepare --moe-impl dense`` and the default ``gathered`` on a
    qwen3_moe target: one file per record from each, the runner holding
    the impl asked for, and the two within bf16's rounding."""
    root = write_family_target(tmp_path / "target", "qwen3_moe", seed=3)
    records = [{"input_ids": s["input_ids"].tolist(),
                "loss_mask": s["loss_mask"].tolist()} for s in samples(3)]
    data = tmp_path / "data.jsonl"
    data.write_text("\n".join(json.dumps(r) for r in records))
    files = {}
    for impl in ("dense", None):
        out = tmp_path / f"out-{impl}"
        argv = ["--target-model", root, "--data", str(data), "--output-dir",
                str(out), "--capture-layers", "0", "1", "2", "--max-length",
                "12", "--device", "cpu"]
        assert prepare.main(argv + (["--moe-impl", impl] if impl else [])) \
            == 0
        files[impl] = sorted(p for p in os.listdir(out) if p.endswith(".sft"))
        assert files[impl] == [f"sample-{i:06d}.sft" for i in range(3)]
    for name in files["dense"]:
        a, _ = pt_ff.load_feature_file(str(tmp_path / "out-dense" / name))
        b, _ = pt_ff.load_feature_file(str(tmp_path / "out-None" / name))
        for key in ("hidden_state", "target"):
            np.testing.assert_allclose(a[key].float().numpy(),
                                       b[key].float().numpy(), rtol=2e-2,
                                       atol=2e-2)
    result = prepare.capture(
        samples(2), target_model=root, output_dir=str(tmp_path / "again"),
        capture_layers=(0, 1, 2), max_length=12, device="cpu",
        moe_impl="dense")
    assert result.runner.moe_impl == "dense"


def test_longcat_capture_layers_follow_logical_layers(tmp_path):
    """longcat's ``num_hidden_layers`` counts its MLA sublayers; the capture
    rule reads the logical layers (``num_layers``): at 4 logical layers
    (8 sublayers) the EAGLE3 rule gives (1, 1, 0)."""
    root = write_family_target(tmp_path / "target", "longcat_flash", seed=4,
                               num_layers=4, num_hidden_layers=8)
    result = prepare.capture(samples(2), target_model=root,
                             output_dir=str(tmp_path / "out"), max_length=12,
                             batch_size=2, device="cpu")
    assert result.runner.target_config.num_hidden_layers == 4
    assert result.capture_layers == (1, 1, 0)
    tensors, meta = pt_ff.load_feature_file(result.written[0])
    assert meta["capture_layers"] == "1,1,0"
    assert tensors["hidden_state"].shape[-1] == 3 * H
