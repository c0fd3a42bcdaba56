"""The port's dense target transformer, offline capture runner and capture
entry point against the JAX package, on the CPU.

``target_capture_forward`` of llama, qwen2 (biased q/k/v) and qwen3 (q/k
norms) targets, saved as tiny HF checkpoints by ``transformers`` and read
by both packages' loaders, equals JAX's in fp32 at
``tests/test_target_transformer.py``'s 2e-4 (padded keys masked); the
loader on single-file, sharded and tied checkpoints and the muP fold; the
refusals of an unsupported family and of EP without a mesh or on a dense
target, and a one-rank capture mesh; both runners on
one checkpoint in the eagle and dflash layouts (files agreeing at 2e-4,
equal metadata, each package reading the other's files); ``python -m
specforge_tpu_torch.offline_capture.prepare`` on tokenised records with its
vocab mapping against JAX's ``derive_vocab_mapping``; and the loop end to
end on the CPU: conversations → capture → ``cli train`` → ``cli export`` →
warm start."""

import json
import os

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
from specforge_tpu.training.vocab_mapping import (
    derive_vocab_mapping as jax_derive_vocab_mapping,
)
from specforge_tpu_torch.algorithms.builtin import builtin_algorithm_registry
from specforge_tpu_torch.models.target import transformer as pt_tf
from specforge_tpu_torch.offline_capture import prepare
from specforge_tpu_torch.offline_capture.capture import (
    OfflineCaptureConfig,
    OfflineCaptureRunner,
)
from specforge_tpu_torch.runtime.data_plane import feature_file as pt_ff
from specforge_tpu_torch.training.vocab_mapping import load_vocab_mapping

TOL = 2e-4  # tests/test_target_transformer.py:88-92
V, H = 128, 32
B, S = 2, 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per worker: several pytest workers share
    the machine in the tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def save_target(root, family, *, tie=False, shard=None, mup=None, seed=0):
    """A tiny HF checkpoint of ``family`` written by ``transformers``
    (sharded when ``shard`` gives a shard size)."""
    import transformers

    common = dict(vocab_size=V, hidden_size=H, intermediate_size=64,
                  num_hidden_layers=4, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=256,
                  tie_word_embeddings=tie)
    config, cls = {
        "llama": (transformers.LlamaConfig(**common),
                  transformers.LlamaForCausalLM),
        "qwen2": (transformers.Qwen2Config(**common),
                  transformers.Qwen2ForCausalLM),
        "qwen3": (transformers.Qwen3Config(head_dim=8, **common),
                  transformers.Qwen3ForCausalLM),
    }[family]
    torch.manual_seed(seed)
    model = cls(config).eval()
    if family == "qwen2":  # give the q/k/v biases values
        with torch.no_grad():
            for layer in model.model.layers:
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                             layer.self_attn.v_proj):
                    proj.bias.normal_(0.0, 0.1)
    kwargs = {"max_shard_size": shard} if shard else {}
    model.save_pretrained(root, safe_serialization=True, **kwargs)
    if mup is not None:
        path = os.path.join(root, "config.json")
        raw = json.load(open(path))
        raw["logits_mup_width_multiplier"] = mup
        json.dump(raw, open(path, "w"))
    return str(root)


def both_params(root, dtype="float32"):
    jcfg = jax_tf.TargetConfig.from_file(root)
    pcfg = pt_tf.TargetConfig.from_file(root)
    jparams = jax_tf.load_target_params(root, jcfg, dtype=getattr(jnp, dtype))
    pparams = pt_tf.load_target_params(root, pcfg, dtype=getattr(torch, dtype),
                                       device="cpu")
    return jcfg, jparams, pcfg, pparams


def ids_and_mask(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, size=(B, S))
    mask = np.ones((B, S), np.int64)
    mask[1, 9:] = 0
    return ids, mask


@pytest.mark.parametrize("family", ["llama", "qwen2", "qwen3"])
def test_capture_forward_matches_jax(tmp_path, family):
    root = save_target(tmp_path, family)
    jcfg, jparams, pcfg, pparams = both_params(root)
    assert pcfg.qk_norm == jcfg.qk_norm == (family == "qwen3")
    assert jcfg.attention_bias == (family == "qwen2")
    assert ("model.layers.0.self_attn.q_proj.bias" in pparams) == (
        family == "qwen2")
    ids, mask = ids_and_mask()
    layers = (1, 2, -1)
    aux_j, last_j, _ = jax_tf.target_capture_forward(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask), layers)
    aux_p, last_p = pt_tf.target_capture_forward(
        pparams, pcfg, torch.as_tensor(ids), torch.as_tensor(mask), layers)
    valid = mask.astype(bool)
    np.testing.assert_allclose(aux_p.numpy()[valid], np.asarray(aux_j)[valid],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(last_p.numpy()[valid],
                               np.asarray(last_j)[valid], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["single", "sharded", "tied", "mup"])
def test_loader_matches_jax(tmp_path, case):
    """The same tensors, bit for bit, as JAX's loader in bf16 (the head
    folded by the muP multiplier, the tied head the embedding)."""
    root = save_target(
        tmp_path, "llama", tie=case == "tied",
        shard="20KB" if case == "sharded" else None,
        mup=0.7 if case == "mup" else None)
    if case == "sharded":
        assert any(n.endswith(".index.json") for n in os.listdir(root))
    _, jparams, _, pparams = both_params(root, "bfloat16")
    assert set(pparams) == set(jparams)
    for key, value in jparams.items():
        np.testing.assert_array_equal(
            pparams[key].float().numpy(), np.asarray(value, np.float32),
            err_msg=key)
    if case == "tied":
        assert torch.equal(pparams["lm_head.weight"],
                           pparams["model.embed_tokens.weight"])


def test_refusals(tmp_path):
    """``bailing_moe`` is refused with the JAX package's reason; EP without
    a mesh and EP on a dense target with JAX's messages
    (``tests/test_moe_ep.py:192``), the runner and ``prepare --moe-impl
    ep`` alike; the loader needs CUDA unless asked. A one-rank capture mesh
    (``prepare --shard-over-devices 1``) captures what one process does."""
    from specforge_tpu_torch.offline_capture.capture import (
        build_capture_mesh,
    )

    root = save_target(tmp_path / "llama", "llama")
    cfg_path = os.path.join(root, "config.json")
    bailing = dict(json.load(open(cfg_path)), model_type="bailing_moe")
    (tmp_path / "bailing").mkdir()
    json.dump(bailing, open(tmp_path / "bailing" / "config.json", "w"))
    reason = jax_tf.UNSUPPORTED_MODEL_TYPES["bailing_moe"]
    with pytest.raises(ValueError, match="bailing_moe") as err:
        pt_tf.TargetConfig.from_file(str(tmp_path / "bailing"))
    assert reason in str(err.value)
    config = OfflineCaptureConfig(root, str(tmp_path / "out"), (1, 1, 1))
    with pytest.raises(ValueError, match="requires a device mesh"):
        OfflineCaptureRunner(config, moe_impl="ep", device="cpu")
    mesh = build_capture_mesh(1, "cpu")
    assert (mesh.world_size, mesh.rank, mesh.transport) == (1, 0, "local")
    with pytest.raises(ValueError, match="needs an MoE target"):
        OfflineCaptureRunner(config, mesh=mesh, moe_impl="ep", device="cpu")
    with pytest.raises(ValueError, match="a capture mesh of 2 ranks needs 2 "
                                         "processes, have 1"):
        build_capture_mesh(2, "cpu")
    data = tmp_path / "data.jsonl"
    data.write_text(json.dumps({"input_ids": list(range(1, 9)),
                                "loss_mask": [1] * 8}) + "\n")
    args = ["--target-model", root, "--data", str(data), "--device", "cpu",
            "--capture-layers", "1", "1", "1", "--max-length", "8"]
    with pytest.raises(ValueError, match="requires a device mesh"):
        prepare.main([*args, "--output-dir", str(tmp_path / "o"),
                      "--moe-impl", "ep"])
    for name, flag in (("one", []), ("mesh", ["--shard-over-devices", "1"])):
        assert prepare.main([*args, "--output-dir", str(tmp_path / name),
                             *flag]) == 0
    one, _ = pt_ff.load_feature_file(str(tmp_path / "one" /
                                         "sample-000000.sft"))
    meshed, _ = pt_ff.load_feature_file(str(tmp_path / "mesh" /
                                            "sample-000000.sft"))
    for key, value in one.items():
        assert torch.equal(meshed[key], value), key
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_tf.load_target_params(root, pt_tf.TargetConfig.from_file(root))


def test_capture_layers_rule():
    """The run's override, else the draft config's layers, else JAX's
    ``(1, n//2 - 1, n - 4)``; the DFlash family its target layer ids."""
    reg = builtin_algorithm_registry()
    eagle = reg.resolve("eagle3").providers
    assert eagle.resolve_capture_layers(None, 36) == (1, 17, 32)
    assert eagle.resolve_capture_layers(None, 36, (2, 3, 4)) == (2, 3, 4)
    with pytest.raises(ValueError, match="3 non-negative"):
        eagle.resolve_capture_layers(None, 36, (1, 2))
    assert reg.resolve("peagle").providers.resolve_capture_layers(
        None, 12) == (1, 5, 8)
    dflash = reg.resolve("dflash").providers
    cfg = dflash.draft_config({
        "vocab_size": V, "hidden_size": H, "intermediate_size": 64,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_hidden_layers": 2, "num_target_layers": 8, "block_size": 4,
        "dflash_config": {"target_layer_ids": [1, 4]}})
    assert dflash.resolve_capture_layers(cfg, 8) == (1, 4)


def samples(n, seed=0, lo=5, hi=S):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(lo, hi + 1))
        out.append({"input_ids": rng.integers(0, V, size=length),
                    "loss_mask": (rng.random(length) > 0.3).astype(np.int64)})
    return out


@pytest.mark.parametrize("layout,layers", [("eagle", (1, 1, 2)),
                                           ("dflash", (0, 2))])
def test_runner_files_match_jax(tmp_path, layout, layers):
    """Both runners over one checkpoint (fp32 weights and files): the same
    sample files, tensors within 2e-4, equal metadata, and each package
    reads the other's files."""
    root = save_target(tmp_path / "target", "qwen3")
    jcfg, jparams, pcfg, pparams = both_params(root)
    data = samples(5)
    out = {}
    for name, runner_cls, cfg_cls, kwargs in (
            ("jax", JaxCaptureRunner, JaxCaptureConfig,
             dict(target_config=jcfg, target_params=jparams)),
            ("port", OfflineCaptureRunner, OfflineCaptureConfig,
             dict(target_config=pcfg, target_params=pparams))):
        out[name] = str(tmp_path / name)
        config = cfg_cls(target_model_path=root, output_dir=out[name],
                         capture_layers=layers, max_length=S, batch_size=2,
                         layout=layout, store_dtype="float32")
        written = runner_cls(config, **kwargs).run(data)
        assert [os.path.basename(p) for p in written] == [
            f"sample-{i:06d}.sft" for i in range(len(data))]
    aux = "hidden_state" if layout == "eagle" else "hidden_states"
    for i, sample in enumerate(data):
        name = f"sample-{i:06d}.sft"
        mine, meta = pt_ff.load_feature_file(os.path.join(out["port"], name))
        ref, ref_meta = jax_ff.load_feature_file(os.path.join(out["jax"], name))
        assert meta == ref_meta == {
            "target_repr": "hidden_state", "layout": layout,
            "capture_layers": ",".join(map(str, layers))}
        assert set(mine) == set(ref)
        np.testing.assert_array_equal(mine["input_ids"].numpy(),
                                      sample["input_ids"])
        np.testing.assert_array_equal(mine["loss_mask"].numpy(),
                                      sample["loss_mask"])
        assert mine[aux].shape == (len(sample["input_ids"]), H * len(layers))
        for key in mine:
            np.testing.assert_allclose(mine[key].numpy(), ref[key], rtol=TOL,
                                       atol=TOL, err_msg=key)
        # the other package's reader on each file
        cross, _ = jax_ff.load_feature_file(os.path.join(out["port"], name))
        back, _ = pt_ff.load_feature_file(os.path.join(out["jax"], name))
        for key in mine:
            np.testing.assert_array_equal(cross[key], mine[key].numpy())
            np.testing.assert_array_equal(back[key].numpy(), ref[key])


def test_prepare_entry_point(tmp_path):
    """``python -m ...prepare`` on tokenised records: the eagle layout at the
    default capture layers of the draft, one file per supervised record,
    and the vocab mapping JAX derives from the same ids."""
    root = save_target(tmp_path / "target", "llama")
    records = [{"input_ids": s["input_ids"].tolist(),
                "loss_mask": s["loss_mask"].tolist()} for s in samples(4)]
    records.append({"input_ids": [1, 2, 3], "loss_mask": [0, 0, 0]})
    data = tmp_path / "data.jsonl"
    data.write_text("\n".join(json.dumps(r) for r in records))
    draft = tmp_path / "draft.json"
    draft.write_text(json.dumps({
        "architectures": ["LlamaEagle3Draft"], "vocab_size": V,
        "draft_vocab_size": 48, "hidden_size": H, "intermediate_size": 64,
        "num_attention_heads": 4, "num_key_value_heads": 2}))
    out = tmp_path / "features"
    assert prepare.main(["--target-model", root, "--data", str(data),
                         "--output-dir", str(out), "--draft-config",
                         str(draft), "--max-length", "10", "--batch-size",
                         "3", "--device", "cpu"]) == 0
    files = sorted(p for p in os.listdir(out) if p.endswith(".sft"))
    assert files == [f"sample-{i:06d}.sft" for i in range(4)]
    tensors, meta = pt_ff.load_feature_file(str(out / files[0]))
    assert meta["capture_layers"] == "1,1,0"  # (1, n//2-1, n-4) at n = 4
    assert tensors["hidden_state"].dtype == torch.bfloat16
    assert tensors["input_ids"].shape[0] <= 10
    t2d, d2t = load_vocab_mapping(str(out / "vocab_mapping.npz"))
    ref = jax_derive_vocab_mapping(
        (np.asarray(r["input_ids"][:10]) for r in records[:4]), V, 48)
    np.testing.assert_array_equal(t2d, ref[0])
    np.testing.assert_array_equal(d2t, ref[1])
    conv = tmp_path / "conv.jsonl"
    conv.write_text(json.dumps({"messages": []}))
    with pytest.raises(ValueError, match="build_dataset"):
        prepare.main(["--target-model", root, "--data", str(conv),
                      "--output-dir", str(out), "--device", "cpu"])


class WordTokenizer:
    """A deterministic word-level stand-in tokenizer (crc32 of each
    whitespace piece into the vocabulary, the BOS id 1)."""

    bos_token_id = 1

    def encode(self, text, add_special_tokens=False):
        import zlib

        return [2 + zlib.crc32(piece.encode()) % (V - 2)
                for piece in text.replace("\n", " \\n ").split()]


CONVERSATION = [
    {"role": "user", "content": "What is two plus two?"},
    {"role": "assistant", "content": "Two plus two equals four."},
    {"role": "user", "content": "And times three?"},
    {"role": "assistant", "content": "Twelve."},
]


def test_capture_train_export_end_to_end(tmp_path):
    """The port twin of ``tests/test_capture_pipeline.py:96``:
    conversations → the qwen template and parser → capture on the dense
    target → ``cli train`` on the captured features (the target's head and
    embedding, the derived vocab mapping) → ``cli export`` → a warm start
    that reads back the checkpoint's weights in bf16."""
    from specforge_tpu_torch import cli
    from specforge_tpu_torch.data.parse import build_dataset
    from specforge_tpu_torch.export.exporter import export_to_hf
    from specforge_tpu_torch.models.target.head import TargetHead
    from specforge_tpu_torch.training.checkpoint import CheckpointManager
    from specforge_tpu_torch.training.model_loading import warm_start_draft

    import transformers

    target = str(tmp_path / "target")
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=V, hidden_size=H, intermediate_size=64,
        num_hidden_layers=6, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256)).save_pretrained(
            target, safe_serialization=True)
    parsed = build_dataset([{"messages": CONVERSATION}] * 6,
                           WordTokenizer(), "qwen", max_length=48)
    assert len(parsed) == 6
    draft_config = {
        "architectures": ["LlamaEagle3Draft"], "vocab_size": V,
        "draft_vocab_size": 48, "hidden_size": H, "intermediate_size": 64,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 256}
    draft_path = tmp_path / "draft.json"
    draft_path.write_text(json.dumps(draft_config))
    features = str(tmp_path / "features")
    result = prepare.capture(
        [{"input_ids": s.input_ids, "loss_mask": s.loss_mask}
         for s in parsed],
        target_model=target, output_dir=features, draft_config=str(
            draft_path), max_length=48, batch_size=4, device="cpu")
    assert result.capture_layers == (1, 2, 2)  # (1, n//2-1, n-4) at n = 6
    assert len(result.written) == 6
    tensors, meta = pt_ff.load_feature_file(result.written[0])
    seq = len(parsed[0].input_ids)
    assert tensors["hidden_state"].shape == (seq, 3 * H)
    assert tensors["target"].shape == (seq, H)
    np.testing.assert_array_equal(tensors["loss_mask"].numpy(),
                                  parsed[0].loss_mask)
    assert meta["target_repr"] == "hidden_state"

    runs = tmp_path / "runs"
    run = tmp_path / "run.json"
    run.write_text(json.dumps({
        "run_id": "cap0", "output_dir": str(runs),
        "model": {"target_model_path": target, "draft_config": draft_config,
                  "vocab_mapping_path": result.vocab_mapping_path},
        "data": {"train_data_path": features, "max_length": 48,
                 "num_workers": 0},
        "training": {"strategy": "eagle3", "batch_size": 2, "num_epochs": 1,
                     "ttt_length": 2, "log_interval": 1},
        "tracking": {"backend": "jsonl"}}))
    assert cli.main(["train", "-c", str(run), "--device", "cpu"]) == 0
    step_dir = CheckpointManager.resolve_step_dir(str(runs))
    assert step_dir.endswith("cap0-step3")
    saved = CheckpointManager.load_state(step_dir)

    export = tmp_path / "export"
    assert cli.main(["export", str(runs), "-o", str(export), "--to",
                     "sglang", "--draft-config", str(draft_path), "--device",
                     "cpu"]) == 0
    providers = builtin_algorithm_registry().resolve("eagle3").providers
    draft, _ = providers.build_draft(draft_config, dtype=torch.float32,
                                     device="cpu", seed=5)
    model = providers.build_training_model(draft, {})
    warm_start_draft(model, str(export))
    state = model.state_dict()
    for name, value in saved["params"].items():
        assert torch.equal(state[name], value.bfloat16().float()), name
    t2d, _ = load_vocab_mapping(result.vocab_mapping_path)
    np.testing.assert_array_equal(state["draft_model.t2d"].numpy(), t2d)

    hf = tmp_path / "hf"
    export_to_hf(str(runs), str(hf), embedding_source=target, device="cpu")
    exported, _ = pt_ff.load_feature_file(str(hf / "model.safetensors"))
    embed = TargetHead.from_pretrained(
        target, lm_head_key="model.embed_tokens.weight").weight
    assert torch.equal(exported["embed_tokens.weight"], embed)
