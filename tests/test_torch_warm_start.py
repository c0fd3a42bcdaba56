"""The port's warm start and muP head against the JAX package, on the CPU.

``warm_start_draft`` from an exported ``model.safetensors`` (the JAX
exporter's torch-convention layout: split q/k/v and gate/up, ``layers.N``,
``embed_proj.{0,2}``, the GRU's ``_l0`` names, bf16 values) for every draft
family, equal exactly to JAX's ``warm_start_draft`` passed through
``convert.params_from_jax``; the muP fold of ``TargetHead.from_pretrained``;
and a tiny ``cli train`` (llama3 RoPE, reference ``.ckpt`` features, warm
started) against JAX's ``build_training_run`` over 2 steps at
``tests/test_torch_train.py``'s curve tolerance (rtol 1e-4), then a warm
start from the port's own step directory."""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.algorithms.builtin import (
    builtin_algorithm_registry as jax_registry,
)
from specforge_tpu.application import composition as jax_composition
from specforge_tpu.config.schema import Config as JaxConfig
from specforge_tpu.export.exporter import (
    _write_safetensors as jax_write_safetensors,
)
from specforge_tpu.export.exporter import flax_to_serving_state
from specforge_tpu.models.target.head import TargetHead as JaxTargetHead
from specforge_tpu.training.model_loading import (
    warm_start_draft as jax_warm_start_draft,
)
from specforge_tpu_torch import cli
from specforge_tpu_torch.algorithms.builtin import builtin_algorithm_registry
from specforge_tpu_torch.application.composition import build_training_run
from specforge_tpu_torch.config.schema import Config
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.models.model_loading import port_name
from specforge_tpu_torch.models.target.head import TargetHead
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    save_feature_file,
)
from specforge_tpu_torch.training.checkpoint import CheckpointManager
from specforge_tpu_torch.training.model_loading import warm_start_draft

V, VD, HID, S = 2048, 512, 128, 64
CURVE_RTOL = 1e-4  # tests/test_train_step.py:123
EAGLE3 = dict(vocab_size=V, draft_vocab_size=VD, hidden_size=HID,
              intermediate_size=3 * HID, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=4096,
              architectures=["LlamaForCausalLMEagle3"], num_hidden_layers=1)
DFLASH = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_attention_heads=4, num_key_value_heads=2,
              num_hidden_layers=2, num_target_layers=8, block_size=4,
              mask_token_id=63, max_position_embeddings=128)
PEAGLE = dict(vocab_size=V, draft_vocab_size=256, hidden_size=64,
              intermediate_size=128, num_attention_heads=4,
              num_key_value_heads=2, head_dim=16, num_hidden_layers=2,
              max_position_embeddings=256)
#: strategy → its tiny draft config (the parity tests' shapes)
FAMILIES = {
    "eagle3": EAGLE3,
    "dflash": DFLASH,
    "domino": dict(DFLASH, projector_type="domino", emb_dim=16,
                   gru_hidden_dim=16, pure_draft_prefix_len=1),
    "dspark": dict(DFLASH, projector_type="dspark", markov_rank=8,
                   markov_head_type="gated", enable_confidence_head=True),
    "peagle": PEAGLE,
}
LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 32}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per worker: several pytest workers share
    the machine in the tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def raw_config(strategy, draft_config):
    """The smallest run of a family: the model's size is the draft's, and
    one TTT step (one P-EAGLE depth) keeps JAX's init trace short."""
    return {"model": {"draft_config": draft_config},
            "data": {"train_data_path": "unused", "max_length": 16},
            "training": {"strategy": strategy, "num_anchors": 2,
                         "ttt_length": 1, "num_depths": 1}}


class _JittedInit:
    """A flax module whose ``init`` runs compiled (eager init traces op by
    op, about 12 s a family on the CPU); ``isinstance`` sees the module's
    class, as the providers' init functions check it."""

    def __init__(self, module):
        self._module = module

    @property
    def __class__(self):
        return type(self._module)

    def init(self, rng, *args):
        return jax.jit(self._module.init)(rng, *args)


def jax_variables(strategy, draft_config, seed=0):
    """A JAX training model's initial variables (numpy leaves)."""
    raw = raw_config(strategy, draft_config)
    options = jax_composition._strategy_options(JaxConfig.model_validate(raw))
    if options.get("mask_token_id") is None:
        options["mask_token_id"] = draft_config.get("mask_token_id", 0)
    providers = jax_registry().resolve(strategy).providers
    draft, cfg = providers.build_draft(draft_config, dtype=jnp.float32)
    model = providers.build_training_model(draft, options)
    variables = providers.init_variables(_JittedInit(model), cfg, options,
                                         jax.random.PRNGKey(seed), 16)
    return jax.device_get({"params": variables["params"],
                           "buffers": variables.get("buffers", {})})


def port_model(strategy, draft_config, variables):
    config = Config.model_validate(raw_config(strategy, draft_config))
    providers = builtin_algorithm_registry().resolve(strategy).providers
    draft, _ = providers.build_draft(
        draft_config, dtype=torch.float32,
        attention_backend=config.training.attention_backend, device="cpu")
    options = {"ttt_length": config.training.ttt_length,
               "num_anchors": config.training.num_anchors,
               "num_depths": config.training.num_depths,
               "mask_token_id": draft_config.get("mask_token_id", 0)}
    model = providers.build_training_model(draft, options)
    model.load_state_dict(params_from_jax(variables), strict=False)
    return model


def perturbed(variables, seed=1):
    """A "trained" draft: every parameter moved by seeded noise."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: (x + rng.normal(size=x.shape) * 0.1).astype(x.dtype),
        variables["params"])
    return {"params": params, "buffers": variables["buffers"]}


def write_export(root, variables, vocab=None, draft_vocab=None):
    """A trained draft exported as the JAX exporter writes it (bf16,
    torch-convention keys, merged projections split), with a vocab map."""
    os.makedirs(root, exist_ok=True)
    draft = variables["params"]["draft_model"]
    buffers = dict(variables["buffers"].get("draft_model", {}))
    if draft_vocab:
        rng = np.random.default_rng(9)
        keep = np.sort(rng.choice(vocab, size=draft_vocab, replace=False))
        t2d = np.zeros(vocab, bool)
        t2d[keep] = True
        buffers = {"t2d": t2d, "d2t": (keep - np.arange(draft_vocab))}
    serving = flax_to_serving_state(draft, buffers)
    jax_write_safetensors(os.path.join(root, "model.safetensors"), serving)
    return serving


def test_port_names_of_exported_keys():
    cases = {
        "layers.0.self_attn.q_proj.weight": "layers_0.self_attn.q_proj.weight",
        "fc_norm.2.weight": "fc_norm_2.weight",
        "embed_proj.0.weight": "embed_proj_0.weight",
        "embed_proj.2.weight": "embed_proj_1.weight",
        "prefix_gru.weight_ih_l0": "prefix_gru.weight_ih",
        "prefix_gru.weight_hh_l0": "prefix_gru.weight_hh",
        "markov_head.markov_w1.weight": "markov_head.markov_w1.weight",
        "midlayer.mlp.down_proj.weight": "midlayer.mlp.down_proj.weight",
        "mask_hidden": "mask_hidden",
    }
    for exported, name in cases.items():
        assert port_name(exported) == name


@pytest.mark.parametrize("strategy", sorted(FAMILIES))
def test_warm_start_from_export_matches_jax(tmp_path, strategy):
    """Every parameter and vocab buffer the export carries, folded and cast
    as JAX folds and casts them; the rest keep their initial values."""
    draft_config = FAMILIES[strategy]
    initial = jax_variables(strategy, draft_config)
    trained = perturbed(initial)
    serving = write_export(str(tmp_path), trained, draft_config["vocab_size"],
                           draft_config.get("draft_vocab_size"))
    if strategy == "dflash":
        assert "layers.0.self_attn.k_proj.weight" in serving
        assert "layers.0.mlp.up_proj.weight" in serving
    ref = params_from_jax(jax.device_get(
        jax_warm_start_draft(initial, str(tmp_path))))

    model = port_model(strategy, draft_config, initial)
    loaded = warm_start_draft(model, str(tmp_path))
    state = model.state_dict()
    assert set(ref) <= set(state)
    assert loaded == len(serving) - sum(
        any(k.endswith(f".{part}.weight") for part in ("k_proj", "v_proj",
                                                       "up_proj"))
        for k in serving)
    before = params_from_jax(initial)
    for name, value in ref.items():
        assert state[name].dtype == value.dtype, name
        torch.testing.assert_close(state[name], value, rtol=0, atol=0,
                                   msg=name)
        if value.dim() >= 2:  # every matrix is the trained draft's
            assert not torch.equal(value, before[name]), name


def test_warm_start_shape_mismatch_raises(tmp_path):
    initial = jax_variables("eagle3", EAGLE3)
    other = jax_variables("eagle3", dict(EAGLE3, intermediate_size=2 * HID))
    write_export(str(tmp_path), other)
    model = port_model("eagle3", EAGLE3, initial)
    with pytest.raises(ValueError, match="shape mismatch at midlayer.mlp"):
        warm_start_draft(model, str(tmp_path))
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_warm_start_draft(initial, str(tmp_path))


def write_target(root, mup=None, where="top", tied=False):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(4)
    tensors = {"model.embed_tokens.weight": torch.from_numpy(
        rng.normal(size=(64, 16)).astype(np.float32)).bfloat16()}
    if not tied:
        tensors["lm_head.weight"] = torch.from_numpy(
            rng.normal(size=(64, 16)).astype(np.float32)).bfloat16()
    save_feature_file(os.path.join(root, "model.safetensors"), tensors)
    config = {"tie_word_embeddings": tied}
    if mup is not None:
        if where == "top":
            config["logits_mup_width_multiplier"] = mup
        else:
            config["text_config"] = {"logits_mup_width_multiplier": mup}
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(config, f)
    return tensors


@pytest.mark.parametrize("mup,where", [(None, "top"), (3.0, "top"),
                                       (0.7, "text_config")])
def test_mup_head_fold_matches_jax(tmp_path, mup, where):
    """The real lm_head is divided by the width multiplier, bf16 as JAX
    divides it; the embedding read through the same loader is not."""
    root = str(tmp_path)
    tensors = write_target(root, mup, where)
    for key in ("lm_head.weight", "model.embed_tokens.weight"):
        got = TargetHead.from_pretrained(root, lm_head_key=key).weight
        ref = JaxTargetHead.from_pretrained(root, lm_head_key=key).weight
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32), err_msg=key)
        if key != "lm_head.weight" or mup is None:
            torch.testing.assert_close(got, tensors[key], rtol=0, atol=0)
        else:
            assert not torch.equal(got, tensors[key])


def test_tied_mup_head_raises_like_jax(tmp_path):
    root = str(tmp_path)
    write_target(root, mup=2.0, tied=True)
    with pytest.raises(ValueError, match="tied embedding"):
        TargetHead.from_pretrained(root)
    with pytest.raises(ValueError, match="tied embedding"):
        JaxTargetHead.from_pretrained(root)
    # the embedding itself reads unscaled
    TargetHead.from_pretrained(root, lm_head_key="model.embed_tokens.weight")


def write_ckpt_features(root, n, seed):
    """Reference-format features: ``torch.save`` dicts, two of them
    gzipped."""
    os.makedirs(root, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    for i in range(n):
        seq = int(torch.randint(40, S + 1, (1,), generator=gen))
        tensors = {
            "input_ids": torch.randint(0, V, (seq,), generator=gen),
            "loss_mask": (torch.rand(seq, generator=gen) > 0.25).long(),
            "hidden_state": torch.randn(seq, 3 * HID,
                                        generator=gen).bfloat16(),
            "target": torch.randn(seq, HID, generator=gen).bfloat16(),
        }
        path = os.path.join(root, f"sample-{i:04d}.ckpt")
        if i < 2:
            with gzip.open(path + ".gz", "wb", compresslevel=1) as f:
                torch.save(tensors, f)
        else:
            torch.save(tensors, path)


def write_target_dir(root):
    rng = np.random.default_rng(1)
    os.makedirs(root, exist_ok=True)
    tensors = {
        "model.embed_tokens.weight": torch.from_numpy(
            rng.normal(size=(V, HID)).astype(np.float32)).bfloat16(),
        "lm_head.weight": torch.from_numpy(
            (rng.normal(size=(V, HID)) * 0.2).astype(np.float32)).bfloat16(),
    }
    save_feature_file(os.path.join(root, "model.safetensors"), tensors)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"vocab_size": V, "hidden_size": HID}, f)


def metric_records(out_dir, run_id):
    with open(os.path.join(out_dir, f"{run_id}.metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train/loss" in r]


def test_cli_train_llama3_ckpt_warm_started_matches_jax(tmp_path):
    """``cli train`` of a llama3-RoPE EAGLE3 draft on ``.ckpt`` features,
    warm-started from an export of a trained draft: its losses, grad norms
    and learning rates equal JAX's over 2 steps (the warm start gives both
    the same weights). Then a warm start from the port's own step-1
    directory loads its saved masters bit for bit, with a fresh optimizer."""
    draft_config = dict(EAGLE3, rope_scaling=LLAMA3)
    data = str(tmp_path / "data")
    write_ckpt_features(data, 4, seed=0)
    target = str(tmp_path / "target")
    write_target_dir(target)
    export = str(tmp_path / "export")
    write_export(export, perturbed(jax_variables("eagle3", draft_config)))
    raw = {
        "run_id": "ws",
        "model": {"draft_config": draft_config, "compute_dtype": "float32",
                  "target_model_path": target,
                  "draft_checkpoint_path": export},
        "data": {"train_data_path": data, "max_length": S, "num_workers": 0},
        "training": {"strategy": "eagle3", "batch_size": 2, "num_epochs": 1,
                     "log_interval": 1, "ttt_length": 3,
                     "compact_teacher": True, "learning_rate": 1e-3,
                     "save_interval": 1, "max_checkpoints": 10},
        "tracking": {"backend": "jsonl"},
    }
    jax_raw = json.loads(json.dumps(raw))
    jax_raw["output_dir"] = str(tmp_path / "jax")
    jax_raw["training"]["attention_backend"] = "dense"
    jax_composition.build_training_run(JaxConfig.model_validate(jax_raw)).fit()

    raw["output_dir"] = str(tmp_path / "runs")
    raw["training"]["attention_backend"] = "pallas"
    path = tmp_path / "run.json"
    path.write_text(json.dumps(raw))
    assert cli.main(["train", "-c", str(path), "--device", "cpu"]) == 0
    steps = metric_records(tmp_path / "runs", "ws")
    jax_steps = metric_records(tmp_path / "jax", "ws")
    assert [r["step"] for r in steps] == [r["step"] for r in jax_steps] == [
        1, 2]
    for mine, ref in zip(steps, jax_steps):
        for key in ("train/loss", "train/grad_norm", "train/lr"):
            np.testing.assert_allclose(mine[key], ref[key], rtol=CURVE_RTOL,
                                       err_msg=f"step {ref['step']} {key}")

    step1 = str(tmp_path / "runs" / "ws-step1")
    saved = CheckpointManager.load_state(step1)
    raw2 = json.loads(json.dumps(raw))
    raw2["run_id"] = "ws2"
    raw2["model"]["draft_checkpoint_path"] = step1
    trainer = build_training_run(Config.model_validate(raw2), device="cpu")
    assert trainer.state.step == 0
    for name, value in saved["params"].items():
        torch.testing.assert_close(trainer.state.params[name], value, rtol=0,
                                   atol=0, msg=name)
    for name in ("draft_model.t2d", "draft_model.d2t"):
        torch.testing.assert_close(trainer.state.buffers[name],
                                   saved["buffers"][name], rtol=0, atol=0)
    for moments in trainer.state.opt_state.values():
        for leaf in (moments.values() if isinstance(moments, dict) else ()):
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
                assert not leaf.any()
