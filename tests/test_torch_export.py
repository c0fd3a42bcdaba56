"""The port's exporter and ``cli export`` against the JAX package, on the
CPU.

Every family in each format the JAX exporter writes it in (SGLang for
EAGLE3 and the DFlash family, HF for all five, P-EAGLE included): the same
trained weights, carried over by ``convert.params_from_jax`` into a port
checkpoint written by ``CheckpointManager`` and handed to JAX's exporter as
its loaded state, give ``model.safetensors`` files equal key for key and
bit for bit, and equal ``config.json`` bytes; the port's export warm-starts
a fresh draft bit-identically to the checkpoint's weights cast to bf16.
Then the rope mirroring and exported-config cases of
``tests/test_export_compat.py:35-146``, the DFlash-family normalisation and
refusals of ``tests/test_dflash_export.py`` (its serving reloads are
``tests/test_torch_serving_dflash.py``'s), and the CLI."""

import json
import os
import types

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as jax_load_file

from specforge_tpu.export import exporter as jax_exporter
from specforge_tpu.training.vocab_mapping import (
    save_vocab_mapping as jax_save_vocab_mapping,
)
from specforge_tpu_torch import cli
from specforge_tpu_torch.algorithms.builtin import builtin_algorithm_registry
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.export import exporter
from specforge_tpu_torch.models.model_loading import port_name
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    load_feature_file,
    save_feature_file,
)
from specforge_tpu_torch.training.checkpoint import (
    CheckpointManager,
    Progress,
    ResumeContract,
)
from specforge_tpu_torch.training.model_loading import warm_start_draft
from tests.test_torch_warm_start import FAMILIES, jax_variables, perturbed

#: the formats the JAX exporter writes each family in
FORMATS = [(s, "sglang") for s in ("eagle3", "dflash", "domino", "dspark")]
FORMATS += [(s, "hf") for s in sorted(FAMILIES)]
#: families whose training state carries no embedding table
NO_EMBEDDING = ("eagle3", "dflash", "dspark")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per worker: several pytest workers share
    the machine in the tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trained():
    """strategy → a "trained" JAX training model's variables (numpy)."""
    cache = {}

    def get(strategy):
        if strategy not in cache:
            cache[strategy] = perturbed(
                jax_variables(strategy, FAMILIES[strategy]))
        return cache[strategy]

    return get


def export_draft_config(path, strategy):
    """The draft config handed to the exporter: the family's with the
    serving fields (``dflash_config``, a modern rope block)."""
    raw = dict(FAMILIES[strategy])
    raw["rope_parameters"] = {"rope_type": "linear", "factor": 2.0,
                              "rope_theta": 10000.0}
    if strategy in ("dflash", "domino", "dspark"):
        raw["dflash_config"] = {"projector_type": strategy,
                                "mask_token_id": raw["mask_token_id"]}
        if strategy == "dspark":
            raw["dflash_config"].update(markov_rank=8,
                                        markov_head_type="gated",
                                        enable_confidence_head=True)
        raw["auto_map"] = {"AutoModel": "x.Y"}
    with open(path, "w") as f:
        json.dump(raw, f)
    return str(path)


def training_state(strategy, variables):
    """The JAX state and the port checkpoint payload of one trained model:
    EAGLE3's frozen embedding is no trainable parameter of either."""
    params = {k: dict(v) for k, v in variables["params"].items()}
    if strategy == "eagle3":
        params["draft_model"].pop("embed_tokens")
    jax_state = {"params": params, "buffers": variables["buffers"]}
    port = params_from_jax(jax_state)
    buffers = {k: v for k, v in port.items() if k.endswith((".t2d", ".d2t"))}
    return jax_state, {
        "params": {k: v for k, v in port.items() if k not in buffers},
        "buffers": buffers}


def write_checkpoint(root, strategy, payload):
    """A port run root holding one step, written by ``CheckpointManager``."""
    manager = CheckpointManager(str(root), "run")
    state = types.SimpleNamespace(params=payload["params"],
                                  buffers=payload["buffers"], opt_state={},
                                  step=1)
    contract = ResumeContract(strategy=strategy, world_size=1,
                              train_batch_size=1, accum_steps=1,
                              total_steps=1, run_id="run")
    manager.save(state, 1, contract, Progress(global_step=1))
    return str(root)


def write_embedding_source(root, vocab, hidden):
    rng = np.random.default_rng(5)
    os.makedirs(root, exist_ok=True)
    save_feature_file(os.path.join(root, "model.safetensors"), {
        "model.embed_tokens.weight": torch.from_numpy(
            rng.normal(size=(vocab, hidden)).astype(np.float32)).bfloat16(),
        "lm_head.weight": torch.from_numpy(
            rng.normal(size=(vocab, hidden)).astype(np.float32)).bfloat16()})
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"vocab_size": vocab, "hidden_size": hidden}, f)
    return str(root)


def fresh_port_model(strategy):
    """A port training model of the family, initialised by torch."""
    draft_config = FAMILIES[strategy]
    providers = builtin_algorithm_registry().resolve(strategy).providers
    draft, _ = providers.build_draft(draft_config, dtype=torch.float32,
                                     device="cpu", seed=11)
    return providers.build_training_model(
        draft, {"ttt_length": 1, "num_anchors": 2, "num_depths": 1,
                "mask_token_id": draft_config.get("mask_token_id", 0)})


def jax_export(monkeypatch, jax_state, strategy, fmt, out, **kwargs):
    """JAX's exporter on the same state (its checkpoint loader replaced by
    the state itself)."""
    monkeypatch.setattr(
        jax_exporter, "load_training_state",
        lambda _ckpt: (jax_state, {"contract": {"strategy": strategy}}))
    return jax_exporter.export_checkpoint("unused", out, fmt, **kwargs)


def assert_same_files(mine_dir, ref_dir):
    mine, meta = load_feature_file(os.path.join(mine_dir, "model.safetensors"))
    ref = jax_load_file(os.path.join(ref_dir, "model.safetensors"))
    assert meta == {}
    assert sorted(mine) == sorted(ref)
    for key, value in ref.items():
        got = mine[key]
        assert tuple(got.shape) == value.shape, key
        if got.dtype == torch.bfloat16:
            assert str(value.dtype) == "bfloat16", key
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), value.view(np.int16),
                err_msg=key)
        else:
            assert got.numpy().dtype == value.dtype, key
            np.testing.assert_array_equal(got.numpy(), value, err_msg=key)
    with open(os.path.join(mine_dir, "config.json"), "rb") as f:
        mine_cfg = f.read()
    with open(os.path.join(ref_dir, "config.json"), "rb") as f:
        assert mine_cfg == f.read()
    return mine


@pytest.mark.parametrize("strategy,fmt", FORMATS)
def test_export_matches_jax_and_warm_starts(tmp_path, monkeypatch, trained,
                                            strategy, fmt):
    variables = trained(strategy)
    jax_state, payload = training_state(strategy, variables)
    ckpt = write_checkpoint(tmp_path / "runs", strategy, payload)
    kwargs = {"draft_config_path": export_draft_config(tmp_path / "d.json",
                                                       strategy)}
    if fmt == "hf" and strategy in NO_EMBEDDING:
        kwargs["embedding_source"] = write_embedding_source(
            tmp_path / "target", FAMILIES[strategy]["vocab_size"],
            FAMILIES[strategy]["hidden_size"])
    if strategy == "eagle3" and fmt == "sglang":
        vocab = FAMILIES[strategy]["vocab_size"]
        keep = np.sort(np.random.default_rng(3).choice(vocab, 512, False))
        t2d = np.zeros(vocab, bool)
        t2d[keep] = True
        path = str(tmp_path / "vocab.npz")
        jax_save_vocab_mapping(path, t2d, keep - np.arange(512))
        kwargs["vocab_mapping_path"] = path
    out = str(tmp_path / "port")
    ref = str(tmp_path / "jax")
    assert exporter.export_checkpoint(ckpt, out, fmt, device="cpu",
                                      **kwargs) == out
    jax_export(monkeypatch, jax_state, strategy, fmt, ref, **kwargs)
    files = assert_same_files(out, ref)
    if "vocab_mapping_path" in kwargs:
        np.testing.assert_array_equal(files["t2d"].numpy(), t2d)

    # the export warm-starts a fresh draft to the checkpoint's weights, cast
    # to bf16, bit for bit
    model = fresh_port_model(strategy)
    warm_start_draft(model, out)
    state = model.state_dict()
    for name, value in payload["params"].items():
        torch.testing.assert_close(
            state[name], value.bfloat16().to(state[name].dtype), rtol=0,
            atol=0, msg=name)
    for name in payload["buffers"]:
        leaf = name.rsplit(".", 1)[1]
        assert torch.equal(state[name], files[leaf].to(state[name].dtype))


def test_serving_names_invert_port_names():
    for name in ("layers_0.self_attn.o_proj.weight", "fc_norm_2.weight",
                 "embed_proj_0.weight", "embed_proj_1.weight",
                 "prefix_gru.weight_ih", "prefix_gru.weight_hh",
                 "markov_head.markov_w1.weight", "mask_hidden"):
        assert port_name(exporter.serving_name(name)) == name


def test_cli_export_and_required_keys(tmp_path, trained, capsys):
    """``cli export`` writes the SGLang layout of a step directory; an
    EAGLE3 state without its head, P-EAGLE to SGLang and an HF export with
    no embedding anywhere raise as in JAX."""
    jax_state, payload = training_state("eagle3", trained("eagle3"))
    ckpt = write_checkpoint(tmp_path / "runs", "eagle3", payload)
    out = tmp_path / "out"
    assert cli.main(["export", os.path.join(ckpt, "run-step1"), "-o",
                     str(out), "--to", "sglang", "--device", "cpu"]) == 0
    tensors, _ = load_feature_file(str(out / "model.safetensors"))
    assert set(exporter.REQUIRED_SGLANG_KEYS) <= set(tensors)
    assert "embed_tokens.weight" not in tensors
    assert json.load(open(out / "config.json")) == {}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exporter.export_checkpoint(ckpt, str(out), "sglang")
    with pytest.raises(ValueError, match="embedding_source"):
        exporter.export_to_hf(ckpt, str(tmp_path / "hf"), device="cpu")

    headless = {"params": {k: v for k, v in payload["params"].items()
                           if "lm_head" not in k},
                "buffers": payload["buffers"]}
    bad = write_checkpoint(tmp_path / "headless", "eagle3", headless)
    with pytest.raises(ValueError, match=r"missing required keys \['lm_head"):
        exporter.export_to_sglang(bad, str(tmp_path / "o2"), device="cpu")

    peagle = write_checkpoint(tmp_path / "peagle", "peagle", training_state(
        "peagle", trained("peagle"))[1])
    with pytest.raises(ValueError, match="use --to hf"):
        exporter.export_to_sglang(peagle, str(tmp_path / "o3"), device="cpu")


def _dflash_error(fn_kwargs, strategy):
    """The message each package raises for one DFlash-family export."""
    messages = []
    for module in (exporter, jax_exporter):
        with pytest.raises(ValueError) as err:
            module._export_dflash_to_sglang({"params": {}}, strategy,
                                            **fn_kwargs)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    return messages[0]


@pytest.mark.parametrize("case", ["no_block_size", "block_size_1",
                                  "projector_mismatch", "no_config",
                                  "missing_keys"])
def test_dflash_refusals_match_jax(tmp_path, case):
    """A DFlash-family export the serving loader could not read is refused
    with JAX's message (``tests/test_dflash_export.py:187``)."""
    config = {"architectures": ["DominoDraftModel"], "block_size": 4,
              "dflash_config": {"projector_type": "domino"}}
    strategy = "dspark" if case == "projector_mismatch" else "domino"
    if case == "no_block_size":
        del config["block_size"]
    elif case == "block_size_1":
        config["block_size"] = 1
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump(config, f)
    messages = []
    for module, extra in ((exporter, {"device": "cpu"}), (jax_exporter, {})):
        with pytest.raises(ValueError) as err:
            module._export_dflash_to_sglang(
                {"params": {}}, strategy, str(tmp_path / "out"),
                draft_config_path=None if case == "no_config" else path,
                **extra)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert {"no_block_size": "block_size", "block_size_1": "block_size",
            "projector_mismatch": "does not match",
            "no_config": "--draft-config",
            "missing_keys": "missing required keys"}[case] in messages[0]


@pytest.mark.parametrize("case", ["head_type", "rank", "conflict"])
def test_dspark_config_refusals_match_jax(tmp_path, trained, case):
    """DSpark's method fields: an unknown head type, a rank that is not a
    positive integer and a top-level field that contradicts the nested one
    are refused with JAX's message."""
    jax_state, payload = training_state("dspark", trained("dspark"))
    draft = json.load(open(export_draft_config(tmp_path / "d.json",
                                               "dspark")))
    if case == "head_type":
        draft["dflash_config"]["markov_head_type"] = "mlp"
    elif case == "rank":
        draft["markov_rank"] = 0
        draft["dflash_config"].pop("markov_rank")
    else:
        draft["enable_confidence_head"] = False
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        json.dump(draft, f)
    messages = []
    for module, state, extra in ((exporter, payload, {"device": "cpu"}),
                                 (jax_exporter, jax_state, {})):
        with pytest.raises(ValueError) as err:
            module._export_dflash_to_sglang(state, "dspark",
                                            str(tmp_path / "out"),
                                            draft_config_path=path, **extra)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert {"head_type": "markov_head_type", "rank": "markov_rank",
            "conflict": "conflict for enable_confidence_head"}[case] in (
        messages[0])


ROPE_CASES = {
    "modern_to_legacy": {"rope_parameters": {
        "rope_type": "yarn", "factor": 4.0, "rope_theta": 500000.0}},
    "legacy_to_modern": {"rope_theta": 1000000.0,
                         "rope_scaling": {"type": "linear", "factor": 2.0}},
    "default_kind": {"rope_parameters": {"rope_type": "default",
                                         "rope_theta": 10000.0}},
    "no_rope_fields": {"hidden_size": 32},
    "both_present": {
        "rope_theta": 500000.0,
        "rope_parameters": {"rope_type": "yarn", "factor": 4.0,
                            "rope_theta": 500000.0},
        "rope_scaling": {"rope_type": "yarn", "factor": 4.0}},
    "stale_theta": {"rope_theta": 1.0, "rope_parameters": {
        "rope_type": "llama3", "factor": 8.0, "rope_theta": 500000.0}},
}


@pytest.mark.parametrize("disabled", [False, True])
@pytest.mark.parametrize("case", sorted(ROPE_CASES))
def test_rope_mirroring_matches_jax(tmp_path, monkeypatch, case, disabled):
    """``apply_legacy_rope_scaling`` returns what JAX's returns and leaves
    the same bytes (``SPECFORGE_DISABLE_LEGACY_ROPE_SCALING=1`` disables
    both)."""
    if disabled:
        monkeypatch.setenv("SPECFORGE_DISABLE_LEGACY_ROPE_SCALING", "1")
    results = []
    for name, module in (("port", exporter), ("jax", jax_exporter)):
        root = tmp_path / name
        root.mkdir()
        (root / "config.json").write_text(json.dumps(ROPE_CASES[case]))
        results.append((module.apply_legacy_rope_scaling(str(root)),
                         (root / "config.json").read_bytes()))
    assert results[0] == results[1]
    if disabled or case in ("no_rope_fields", "both_present"):
        assert not results[0][0]


@pytest.mark.parametrize("with_config", [True, False])
def test_write_config_matches_jax(tmp_path, with_config):
    draft = tmp_path / "draft.json"
    draft.write_text(json.dumps({
        "architectures": ["LlamaEagle3Draft"],
        "rope_parameters": {"rope_type": "llama3", "factor": 8.0,
                            "rope_theta": 500000.0}}))
    outs = []
    for name, module in (("port", exporter), ("jax", jax_exporter)):
        out = tmp_path / name
        out.mkdir()
        module._write_config(str(out), str(draft) if with_config else None,
                             {"extra": 1})
        outs.append((out / "config.json").read_bytes())
    assert outs[0] == outs[1]
    if with_config:
        cfg = json.loads(outs[0])
        assert cfg["rope_scaling"]["factor"] == 8.0
        assert cfg["rope_theta"] == 500000.0


@pytest.mark.parametrize("strategy", ["domino", "dspark"])
def test_dflash_normalisation(tmp_path, trained, strategy):
    """The serving config of ``tests/test_dflash_export.py``: the serving
    class, DSpark's method fields top-level, ``auto_map`` dropped, the
    head keys present."""
    _, payload = training_state(strategy, trained(strategy))
    ckpt = write_checkpoint(tmp_path / "runs", strategy, payload)
    draft = export_draft_config(tmp_path / "d.json", strategy)
    out = str(tmp_path / "port")
    exporter.export_to_sglang(ckpt, out, draft_config_path=draft,
                              device="cpu")
    cfg = json.load(open(os.path.join(out, "config.json")))
    tensors, _ = load_feature_file(os.path.join(out, "model.safetensors"))
    assert "auto_map" not in cfg
    assert cfg["block_size"] == 4
    if strategy == "domino":
        assert cfg["architectures"] == ["DFlashDraftModel"]
        keys = exporter._DFLASH_HEAD_KEYS["domino"]
    else:
        assert cfg["architectures"] == ["Qwen3DSparkModel"]
        assert cfg["markov_rank"] == 8
        assert cfg["markov_head_type"] == "gated"
        assert cfg["enable_confidence_head"] is True
        keys = exporter._DFLASH_HEAD_KEYS["dspark"] + (
            "markov_head.gate_proj.weight",)
    assert set(keys) <= set(tensors)
