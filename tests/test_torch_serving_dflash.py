"""The port's DFlash-family block serving against the JAX package, on the CPU.

The shapes of ``tests/test_spec_decode.py:490-565`` (a 6-layer Llama target
with vocab 128, hidden 32 and 4 heads over 2 KV heads; a 2-layer draft with
blocks of 4 reading capture layers (1, 4); fp32): for DFlash, Domino and
DSpark drafts carried over from JAX's variables by
``convert.params_from_jax``, the port's host loop and fused rounds give the
tokens and accept lengths of JAX's fused loop, and greedy decoding's; stop
tokens; one fused program for every stop set; ``load_exported_dflash_draft``
against JAX's loader, bit for bit, on exports of both packages; the
refusals naming their ``ROADMAP.md`` Queue 1 items; and the twin of
``scripts/gates/dflash_serving_gate.py``: a tiny port ``cli train`` of
Domino on features the port captured, ``cli export --to sglang``, then the
port's decoder on the export, equal to greedy decoding and to JAX's
decoder on the same export. JAX's draft runs its chunked attention, as
tier-1 runs it on the CPU; the port's runs the DFlash kernel's plain
version."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.inference import serving_loaders as jax_loaders
from specforge_tpu.inference import spec_decode as jax_sd
from specforge_tpu.models.draft.dflash import (
    DFlashConfig as JaxDFlashConfig,
    DFlashDraftModel as JaxDFlash,
)
from specforge_tpu.models.draft.domino import DominoDraftModel as JaxDomino
from specforge_tpu.models.draft.dspark import DSparkDraftModel as JaxDSpark
from specforge_tpu_torch import cli
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.export import exporter
from specforge_tpu_torch.inference import serving_loaders, spec_decode
from specforge_tpu_torch.models.draft.dflash import DFlashConfig
from specforge_tpu_torch.models.target import transformer as pt_tf
from specforge_tpu_torch.offline_capture import prepare
from tests.test_torch_export import jax_export, write_checkpoint
from tests.test_torch_serving import V, H, both_targets, save_llama

BS = 4
LAYERS = (1, 4)
MAX_LEN = 256
#: the family heads of tests/test_spec_decode.py:500-507
HEADS = {
    "dflash": {},
    "domino": {"pure_draft_prefix_len": 1, "emb_dim": 16,
               "gru_hidden_dim": 16, "shift_label": True,
               "projector_type": "domino"},
    "dspark": {"markov_rank": 8, "markov_head_type": "gated",
               "enable_confidence_head": True, "projector_type": "dspark"},
}
PROJECTORS = sorted(HEADS)
JAX_CLASSES = {"dflash": JaxDFlash, "domino": JaxDomino, "dspark": JaxDSpark}
#: the gate's Domino run: sequences a sharpened target decodes greedily,
#: captured at the draft's layers, trained long enough to accept more than
#: one token a round on average
GATE_SEQ_LEN, GATE_SEQS, GATE_EPOCHS = 48, 16, 40


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per worker: several pytest workers share
    the machine in the tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def draft_config(projector, **extra):
    """The draft config of tests/test_spec_decode.py:508-516."""
    return {
        "architectures": ["DFlashDraftModel"],
        "vocab_size": V, "hidden_size": H, "intermediate_size": 64,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_hidden_layers": 2, "num_target_layers": 6, "block_size": BS,
        "max_position_embeddings": 512, **extra,
        "dflash_config": {"mask_token_id": V - 1,
                          "target_layer_ids": list(LAYERS),
                          **HEADS[projector]},
    }


def jax_init(module, cfg, seed=1):
    """JAX's variables through every head (tests/test_spec_decode.py:
    521-543)."""
    n_capture = len(cfg.resolved_target_layer_ids)

    def init_all(mod, noise, ctx, ctx_pos, draft_pos, anchors, keep,
                 prev_emb, prev_ids):
        hidden = mod(noise, ctx, ctx_pos, draft_pos, anchors, keep)
        hs = hidden[:, None]
        base = jnp.zeros((1, 1, BS, V), jnp.float32)
        mod.apply_logits_head(base, prev_token_ids=prev_ids,
                              prev_token_embeddings=prev_emb,
                              hidden_states=hs)
        mod.predict_confidence(hs, prev_token_ids=prev_ids)
        return hidden

    return jax.device_get(module.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, BS, H), jnp.float32),
        jnp.zeros((1, 16, n_capture * H), jnp.float32),
        jnp.zeros((1, 16), jnp.int32), jnp.zeros((1, BS), jnp.int32),
        jnp.zeros((1, 1), jnp.int32), jnp.ones((1, 1), bool),
        jnp.zeros((1, 1, BS, H), jnp.float32),
        jnp.zeros((1, 1, BS), jnp.int32), method=init_all))


def port_draft(projector, raw, state, dtype=torch.float32):
    cls = serving_loaders.DFLASH_DRAFTS[projector]
    draft = cls(DFlashConfig.from_dict(raw), dtype=dtype, device="cpu")
    draft.load_state_dict(state)
    return draft.eval()


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    return both_targets(save_llama(tmp_path_factory.mktemp("target")))


@functools.lru_cache(maxsize=None)
def jax_variables(projector):
    """JAX's random fp32 variables of ``projector``'s draft, made once for
    the decoders and the exports (JAX traces each head on first use)."""
    cfg = JaxDFlashConfig.from_dict(draft_config(projector))
    return jax_init(JAX_CLASSES[projector](cfg, dtype=jnp.float32), cfg)


@pytest.fixture(scope="module")
def decoders(target):
    """projector → (JAX's decoder, the port's) over the same fp32 target
    and random fp32 draft."""
    jparams, jcfg, pparams, pcfg = target
    made = {}

    def get(projector):
        if projector not in made:
            raw = draft_config(projector)
            cfg = JaxDFlashConfig.from_dict(raw)
            module = JAX_CLASSES[projector](cfg, dtype=jnp.float32,
                                            attn_chunk_blocks=1)
            variables = jax_variables(projector)
            draft = port_draft(projector, raw, params_from_jax(variables))
            made[projector] = (
                jax_sd.DFlashSpecDecoder(jparams, jcfg, module, variables,
                                         max_len=MAX_LEN),
                spec_decode.DFlashSpecDecoder(pparams, pcfg, draft,
                                              max_len=MAX_LEN, device="cpu"))
        return made[projector]

    return get


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.output_ids, want.output_ids)
    assert got.accept_lengths == [int(a) for a in want.accept_lengths]
    assert got.steps == want.steps


@pytest.mark.parametrize("projector", PROJECTORS)
def test_block_decoder_matches_jax(target, decoders, projector):
    """``generate`` and ``generate_fused`` against JAX's fused loop: the
    same output ids and accept lengths, and greedy decoding's output (the
    invariant); no graphs on the CPU."""
    jdec, pdec = decoders(projector)
    assert pdec.capture_layers == LAYERS and pdec.block_size == BS
    prompt = np.random.default_rng(5).integers(0, V - 1, size=17).tolist()
    want = jdec.generate_fused(prompt, max_new_tokens=20)
    assert_same_result(pdec.generate(prompt, max_new_tokens=20), want)
    assert_same_result(pdec.generate_fused(prompt, max_new_tokens=20), want)
    greedy = spec_decode.greedy_target_decode(
        target[2], target[3], prompt, 20, capture_layers=LAYERS,
        max_len=MAX_LEN)
    n = min(len(greedy), len(want.output_ids))
    np.testing.assert_array_equal(want.output_ids[:n], greedy[:n])
    assert pdec._fused.replays == 0


@pytest.mark.parametrize("projector", ["domino", "dspark"])
def test_block_stop_tokens_match_jax(decoders, projector):
    """A stop token the target emits mid-run: the port's host loop and
    fused rounds stop where JAX's fused loop stops."""
    jdec, pdec = decoders(projector)
    prompt = np.random.default_rng(7).integers(0, V - 1, size=12).tolist()
    free = pdec.generate(prompt, max_new_tokens=24)
    emitted = [int(t) for t in free.output_ids[len(prompt) + 1:]]
    stop = [emitted[len(emitted) // 2]]
    want = jdec.generate_fused(prompt, max_new_tokens=24, stop_token_ids=stop)
    assert_same_result(pdec.generate(prompt, 24, stop_token_ids=stop), want)
    assert_same_result(pdec.generate_fused(prompt, 24, stop_token_ids=stop),
                       want)
    assert len(want.output_ids) < len(free.output_ids)


def test_stop_sets_share_one_block_program(decoders):
    """Requests with other stop sets and prompt lengths reuse one fused
    program and its buffers, and stop where the host loop stops; more than
    ``STOP_SLOTS`` stop ids raise."""
    _, pdec = decoders("domino")
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, V - 1, size=14).tolist()
    emitted = [int(t) for t in pdec.generate(prompt, 24).output_ids]
    for stop, ids in (([emitted[-12]], prompt), ([emitted[-6], V - 1], prompt),
                      ([], prompt[:9])):
        assert_same_result(pdec.generate_fused(ids, 24, stop_token_ids=stop),
                           pdec.generate(ids, 24, stop_token_ids=stop))
    assert list(pdec._fused._cache) == [("block", MAX_LEN)]
    with pytest.raises(ValueError, match="at most"):
        pdec.generate_fused(prompt, 4,
                            stop_token_ids=range(spec_decode.STOP_SLOTS + 1))


# --------------------------------------------------------------------------
# the export loader
# --------------------------------------------------------------------------

def write_draft_config(path, projector):
    with open(path, "w") as f:
        json.dump(draft_config(projector), f)
    return str(path)


def both_exports(tmp_path, monkeypatch, projector, source):
    """JAX's random draft exported to the SGLang layout by ``source``'s
    exporter from the same weights → the export's directory."""
    variables = jax_variables(projector)
    jax_state = {"params": {"draft_model": variables["params"]},
                 "buffers": {}}
    config_path = write_draft_config(tmp_path / "draft.json", projector)
    out = str(tmp_path / source)
    if source == "jax":
        jax_export(monkeypatch, jax_state, projector, "sglang", out,
                   draft_config_path=config_path)
    else:
        ckpt = write_checkpoint(tmp_path / "runs", projector,
                                {"params": params_from_jax(jax_state),
                                 "buffers": {}})
        exporter.export_checkpoint(ckpt, out, "sglang",
                                   draft_config_path=config_path,
                                   device="cpu")
    return out


def assert_dflash_loaders_agree(export):
    """The port's loader against JAX's, bit for bit in bf16 → the port's
    draft."""
    draft = serving_loaders.load_exported_dflash_draft(export, device="cpu")
    _, variables = jax_loaders.load_exported_dflash_draft(export)
    want = params_from_jax(jax.device_get(variables))
    got = draft.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in got.items():
        assert value.dtype == torch.bfloat16, name
        assert torch.equal(value.float(), want[name]), name
    return draft


@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("projector", PROJECTORS)
def test_load_exported_dflash_draft_matches_jax(tmp_path, monkeypatch,
                                                projector, source):
    """A DFlash, Domino and DSpark SGLang export, written by either
    package's exporter, loads bit-identically in bf16 in both packages, as
    the class its ``projector_type`` names (not its serving
    ``architectures``), every head's weights filled; ``load_exported_draft``
    and ``load_spec_models`` take the same path."""
    export = both_exports(tmp_path, monkeypatch, projector, source)
    draft = assert_dflash_loaders_agree(export)
    assert type(draft) is serving_loaders.DFLASH_DRAFTS[projector]
    assert serving_loaders.read_export_family(export) == "dflash"
    again = serving_loaders.load_exported_draft(export, device="cpu")
    for name, value in again.state_dict().items():
        assert torch.equal(value, draft.state_dict()[name]), name


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_load_exported_dflash_draft_names_a_bad_tensor(tmp_path, monkeypatch,
                                                       fault):
    """An export without one of the Domino head's tensors, or with one of
    the wrong shape, raises with the tensor's name."""
    from specforge_tpu_torch.runtime.data_plane.feature_file import (
        load_feature_file,
        save_feature_file,
    )

    export = both_exports(tmp_path, monkeypatch, "domino", "port")
    path = os.path.join(export, "model.safetensors")
    tensors, _ = load_feature_file(path)
    key = "prefix_gru.weight_hh_l0"
    if fault == "missing":
        tensors.pop(key)
        match = "prefix_gru.weight_hh"
    else:
        tensors[key] = tensors[key][:-1]
        match = "mismatch at prefix_gru.weight_hh"
    save_feature_file(path, tensors)
    with pytest.raises(ValueError, match=match):
        serving_loaders.load_exported_dflash_draft(export, device="cpu")


@pytest.mark.parametrize("call,item", [("batch", "item 8d"),
                                       ("mesh", "item 8e"),
                                       ("peagle_export", "item 8b")])
def test_block_refusals_name_their_item(target, decoders, tmp_path, call,
                                        item):
    """What the port does not serve yet raises a ValueError naming its
    ``ROADMAP.md`` Queue 1 item: the batched block decoder (8d), a device
    mesh (8e) and a P-EAGLE export (8b)."""
    _, pdec = decoders("dflash")
    export = tmp_path / "export"
    export.mkdir()
    (export / "config.json").write_text(json.dumps(
        {"architectures": ["PEagleDraftModel"], "vocab_size": V}))
    calls = {
        "batch": lambda: pdec.generate_batch_fused([[1, 2]], 4),
        "mesh": lambda: spec_decode.DFlashSpecDecoder(
            target[2], target[3], pdec.draft, max_len=64, mesh=object(),
            device="cpu"),
        "peagle_export": lambda: serving_loaders.load_exported_draft(
            str(export), device="cpu"),
    }
    with pytest.raises(ValueError, match=item):
        calls[call]()


# --------------------------------------------------------------------------
# the gate: capture → train → export → serve
# --------------------------------------------------------------------------

def domino_gate(root):
    """A sharpened tiny target, sequences it decodes greedily captured in
    the dflash layout by ``prepare.capture``, ``cli train`` of Domino
    on them, ``cli export --to sglang`` → (target dir, export dir, the
    sequences)."""
    root = str(root)
    target = save_llama(os.path.join(root, "target"), head_scale=6.0)
    config = pt_tf.TargetConfig.from_file(target)
    params = pt_tf.load_target_params(target, config, dtype=torch.float32,
                                      device="cpu")
    rng = np.random.default_rng(0)
    seqs = [spec_decode.greedy_target_decode(
        params, config, rng.integers(0, V - 1, size=4).tolist(),
        GATE_SEQ_LEN - 4, capture_layers=(), max_len=64)[:GATE_SEQ_LEN]
        for _ in range(GATE_SEQS)]
    draft_path = write_draft_config(os.path.join(root, "draft.json"),
                                    "domino")
    prepare.capture(
        [{"input_ids": np.asarray(s),
          "loss_mask": np.ones(GATE_SEQ_LEN, np.int64)} for s in seqs],
        target_model=target, output_dir=os.path.join(root, "features"),
        algorithm="domino", draft_config=draft_path,
        max_length=GATE_SEQ_LEN, batch_size=8, device="cpu")
    runs = os.path.join(root, "runs")
    run = os.path.join(root, "run.json")
    with open(run, "w") as f:
        json.dump({
            "run_id": "gate", "output_dir": runs,
            "model": {"target_model_path": target,
                      "draft_config_path": draft_path,
                      "compute_dtype": "float32"},
            "data": {"train_data_path": os.path.join(root, "features"),
                     "max_length": GATE_SEQ_LEN, "num_workers": 0},
            "training": {"strategy": "domino", "batch_size": 8,
                         "num_epochs": GATE_EPOCHS, "learning_rate": 1e-2,
                         "warmup_ratio": 0.05, "num_anchors": 8,
                         "objective_chunk_blocks": 4, "log_interval": 100,
                         "max_checkpoints": 1},
            "tracking": {"backend": "none"}}, f)
    assert cli.main(["train", "-c", run, "--device", "cpu"]) == 0
    export = os.path.join(root, "export")
    assert cli.main(["export", runs, "-o", export, "--to", "sglang",
                     "--draft-config", draft_path, "--device", "cpu"]) == 0
    return target, export, seqs


def test_dflash_gate_end_to_end(tmp_path):
    """``scripts/gates/dflash_serving_gate.py`` with the port: a Domino
    draft trained and exported by the port, loaded by
    ``load_spec_models`` and served by ``build_decoder``'s block decoder
    (fp32 target, bf16 weights computing in fp32), emits greedy decoding's
    tokens and JAX's decoder's tokens and accept lengths on the same
    export, accepting more than one token a round on average."""
    target, export, seqs = domino_gate(tmp_path)
    jparams, jcfg, pparams, pcfg = both_targets(target)
    models = serving_loaders.load_spec_models(target, export,
                                              dtype=torch.float32,
                                              device="cpu")
    loaded = models[2]
    draft = port_draft("domino", draft_config("domino"), loaded.state_dict())
    decoder = serving_loaders.build_decoder((pparams, pcfg, draft),
                                            max_len=MAX_LEN, device="cpu")
    assert isinstance(decoder, spec_decode.DFlashSpecDecoder)
    module, variables = jax_loaders.load_exported_dflash_draft(export)
    jdec = jax_sd.DFlashSpecDecoder(
        jparams, jcfg, JaxDomino(module.config, dtype=jnp.float32,
                                 attn_chunk_blocks=1),
        variables, max_len=MAX_LEN)
    accepts = []
    for seq in seqs[:2]:
        prompt = [int(t) for t in seq[:8]]
        got = decoder.generate_fused(prompt, max_new_tokens=16)
        assert_same_result(decoder.generate(prompt, max_new_tokens=16), got)
        assert_same_result(got, jdec.generate_fused(prompt, max_new_tokens=16))
        greedy = spec_decode.greedy_target_decode(pparams, pcfg, prompt, 16,
                                                  max_len=MAX_LEN)
        np.testing.assert_array_equal(got.output_ids[:len(greedy)], greedy)
        accepts += got.accept_lengths
    assert np.mean(accepts) > 1.5
