"""The port's chain speculative serving against the JAX package, on the CPU.

The cached target forward (causal in two blocks, a tree block, per-row
lengths with a pad mask) and the cached draft step at rtol = atol = 1e-5,
the plain greedy decoders token for token (the budget guard and stop
tokens), the chain decoder's host loop and fused rounds against JAX's for
k = 2 and 4 on a random draft and on a trained, exported one (output ids
and accept lengths identical, partial acceptance exercised), the export
loader bit for bit in bf16 against JAX's, and the refusals that name
their ``ROADMAP.md`` Queue 1 item (8b-8e). The shapes are those of
``tests/test_spec_decode.py:21-53``; every weight is loaded by both
packages from one HF directory or export, or carried over by
``convert.params_from_jax``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from specforge_tpu.inference import serving_loaders as jax_loaders
from specforge_tpu.inference import spec_decode as jax_sd
from specforge_tpu.models.draft.llama_eagle3 import (
    Eagle3Config as JaxEagle3Config,
    LlamaEagle3Draft as JaxDraft,
)
from specforge_tpu.models.target import transformer as jax_tf
from specforge_tpu_torch import cli
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.export.exporter import export_to_hf
from specforge_tpu_torch.inference import serving_loaders, spec_decode
from specforge_tpu_torch.models.draft.dflash import DFlashConfig
from specforge_tpu_torch.models.draft.domino import DominoDraftModel
from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    LlamaEagle3Draft,
)
from specforge_tpu_torch.models.draft.peagle import (
    PEagleConfig,
    PEagleDraftModel,
)
from specforge_tpu_torch.models.target import transformer as pt_tf
from specforge_tpu_torch.offline_capture import prepare
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    load_feature_file,
)

V, H = 128, 32
TOL = 1e-5
DRAFT_KW = dict(vocab_size=V, draft_vocab_size=V, hidden_size=H,
                intermediate_size=64, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=512,
                target_hidden_size=H)
#: the trained draft's config and run: tests/test_spec_decode.py:120-250
#: (a sharpened target, sequences it decodes greedily, a short run), with
#: more steps at a higher rate so that its mean accept length passes 1.5
#: (2.1-2.2 at k = 2 and 4, many rounds of partial acceptance)
TRAINED_DRAFT = {
    "architectures": ["LlamaEagle3Draft"], "vocab_size": V,
    "draft_vocab_size": V, "hidden_size": H, "intermediate_size": 128,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "max_position_embeddings": 512}
SEQ_LEN, N_SEQS = 48, 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per worker: several pytest workers share
    the machine in the tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def save_llama(path, layers=6, head_scale=None, seed=0):
    """A tiny HF llama written by ``transformers`` (``head_scale``
    sharpens its head, as tests/test_spec_decode.py:152-160 does)."""
    torch.manual_seed(seed)
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=V, hidden_size=H, intermediate_size=64,
        num_hidden_layers=layers, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=512))
    if head_scale is not None:
        with torch.no_grad():
            model.lm_head.weight *= head_scale
    model.save_pretrained(path, safe_serialization=True)
    return str(path)


def both_targets(path):
    """The target of ``path`` loaded by both packages in fp32 →
    (jax params, jax config, port params, port config)."""
    jcfg = jax_tf.TargetConfig.from_file(path)
    pcfg = pt_tf.TargetConfig.from_file(path)
    return (jax_tf.load_target_params(path, jcfg, dtype=jnp.float32), jcfg,
            pt_tf.load_target_params(path, pcfg, dtype=torch.float32,
                                     device="cpu"), pcfg)


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    return both_targets(save_llama(tmp_path_factory.mktemp("target")))


@pytest.fixture(scope="module")
def random_draft():
    """JAX's random fp32 draft of tests/test_spec_decode.py:40-53 and the
    port's copy of it."""
    module = JaxDraft(JaxEagle3Config(**DRAFT_KW), dtype=jnp.float32)
    variables = jax.device_get(module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.zeros((1, 8, 3 * H), jnp.float32)))
    draft = LlamaEagle3Draft(Eagle3Config(**DRAFT_KW), dtype=torch.float32,
                             device="cpu")
    draft.load_state_dict(params_from_jax(variables))
    return module, variables, draft


def train_and_export(root, epochs, target=None):
    """The port's capture → train → export loop on a sharpened tiny target:
    sequences the target decodes greedily, captured at the default layers
    by ``prepare.capture``, ``cli train`` for ``epochs`` epochs, ``cli
    export --to sglang`` → (target dir, SGLang export dir, the sequences,
    the run root)."""
    root = str(root)
    target = target or save_llama(os.path.join(root, "target"),
                                  head_scale=6.0)
    config = pt_tf.TargetConfig.from_file(target)
    params = pt_tf.load_target_params(target, config, dtype=torch.float32,
                                      device="cpu")
    rng = np.random.default_rng(0)
    seqs = [spec_decode.greedy_target_decode(
        params, config, rng.integers(0, V, size=4).tolist(), SEQ_LEN - 4,
        capture_layers=(), max_len=64)[:SEQ_LEN] for _ in range(N_SEQS)]
    draft_path = os.path.join(root, "draft.json")
    with open(draft_path, "w") as f:
        json.dump(TRAINED_DRAFT, f)
    captured = prepare.capture(
        [{"input_ids": np.asarray(s), "loss_mask": np.ones(SEQ_LEN, np.int64)}
         for s in seqs],
        target_model=target, output_dir=os.path.join(root, "features"),
        draft_config=draft_path, max_length=SEQ_LEN, batch_size=8,
        device="cpu")
    runs = os.path.join(root, "runs")
    run = os.path.join(root, "run.json")
    with open(run, "w") as f:
        json.dump({
            "run_id": "spec", "output_dir": runs,
            "model": {"target_model_path": target,
                      "draft_config": TRAINED_DRAFT,
                      "vocab_mapping_path": captured.vocab_mapping_path,
                      "compute_dtype": "float32"},
            "data": {"train_data_path": os.path.join(root, "features"),
                     "max_length": SEQ_LEN, "num_workers": 0},
            "training": {"strategy": "eagle3", "batch_size": 8,
                         "num_epochs": epochs, "learning_rate": 1e-2,
                         "warmup_ratio": 0.05, "ttt_length": 3,
                         "log_interval": 100, "max_checkpoints": 1},
            "tracking": {"backend": "none"}}, f)
    assert cli.main(["train", "-c", run, "--device", "cpu"]) == 0
    export = os.path.join(root, "export")
    assert cli.main(["export", runs, "-o", export, "--to", "sglang",
                     "--draft-config", draft_path, "--device", "cpu"]) == 0
    return target, export, seqs, runs


def jax_exported_draft(export, embedding, dtype=jnp.float32):
    """JAX's loader, the module rebuilt to compute in ``dtype`` over the
    loaded (bf16) variables."""
    module, variables = jax_loaders.load_exported_draft(
        export, fallback_embedding=embedding)
    return JaxDraft(module.config, dtype=dtype), variables


def computing_in(draft, dtype):
    """``draft``'s (bf16) weights in a copy that computes in ``dtype``, as
    ``jax_exported_draft`` rebuilds JAX's module."""
    copy = LlamaEagle3Draft(draft.config, dtype=dtype, device="cpu")
    copy.load_state_dict(draft.state_dict())
    return copy.to(torch.bfloat16).eval()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A draft trained and exported by the port, loaded by both packages
    (fp32 compute over bf16 weights, fp32 target)."""
    root = tmp_path_factory.mktemp("trained")
    target, export, seqs, runs = train_and_export(root, epochs=120)
    jparams, jcfg, pparams, pcfg = both_targets(target)
    embed = np.asarray(jparams["model.embed_tokens.weight"], np.float32)
    module, variables = jax_exported_draft(export, embed)
    draft = computing_in(serving_loaders.load_exported_draft(
        export, pparams["model.embed_tokens.weight"], device="cpu"),
        torch.float32)
    prompts = [list(map(int, s[:8])) for s in seqs[:2]]
    return {"target": target, "export": export, "runs": runs,
            "draft_config": os.path.join(str(root), "draft.json"),
            "jax": (jparams, jcfg, module, variables),
            "port": (pparams, pcfg, draft), "prompts": prompts}


def assert_close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got), np.asarray(want, np.float32),
        rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# cached forwards
# --------------------------------------------------------------------------

def tree_layout(k, n_chains):
    """tests/test_spec_decode.py's tree block: slot 0 the committed token,
    chain c at slots 1+c*k .., each node seeing slot 0 and its chain."""
    t = 1 + n_chains * k
    allow = np.zeros((t, t), bool)
    allow[:, 0] = True
    pos = np.zeros((t,), np.int32)
    for c in range(n_chains):
        for j in range(k):
            s = 1 + c * k + j
            allow[s, 1 + c * k: s + 1] = True
            pos[s] = j + 1
    return allow, pos


def both_forwards(target, ids, caches, cache_len, layers, **masks):
    """One block through both packages' cached forwards, the port's on a
    copy of its caches → (jax outputs, port outputs)."""
    jparams, jcfg, pparams, pcfg = target
    (jk, jv), (pk, pv) = caches
    jout = jax_sd.target_cached_forward(
        jparams, jcfg, jnp.asarray(ids, jnp.int32), jk, jv,
        jnp.asarray(cache_len, jnp.int32), layers,
        **{k: jnp.asarray(v) for k, v in masks.items()})
    pout = spec_decode.target_cached_forward(
        pparams, pcfg, torch.as_tensor(ids), pk.clone(), pv.clone(),
        torch.as_tensor(np.asarray(cache_len)), layers,
        **{k: torch.as_tensor(v) for k, v in masks.items()})
    return jout, pout


def prefill_both(target, ids, m=64):
    """Both packages' fp32 caches after a causal prefill of ``ids``."""
    jparams, jcfg, pparams, pcfg = target
    js = jax_sd.init_target_state(jcfg, ids.shape[0], m, dtype=jnp.float32)
    ps = spec_decode.init_target_state(pcfg, ids.shape[0], m,
                                       dtype=torch.float32, device="cpu")
    jout, pout = both_forwards(target, ids, ((js.cache_k, js.cache_v),
                                             (ps.cache_k, ps.cache_v)), 0,
                               (1,))
    return (jout[2], jout[3]), (pout[2], pout[3])


@pytest.mark.parametrize("mode", ["causal", "tree", "per_row",
                                  "per_row_tree", "per_row_beam"])
def test_cached_forward_matches_jax(target, mode):
    """Logits, aux and caches at 1e-5: causal in two blocks, a tree block
    (``block_allow``/``block_positions``), per-row lengths with
    ``prefix_valid`` (causal, a shared [T, T] tree and per-row [B, T, T]
    trees)."""
    rng = np.random.default_rng(0)
    layers = (1, 3)
    allow, pos = tree_layout(2, 2)
    if mode in ("causal", "tree"):
        ids = rng.integers(0, V, size=(1, 9))
        caches = prefill_both(target, ids)
        block = rng.integers(0, V, size=(1, 5))
        masks = ({} if mode == "causal" else
                 {"block_allow": allow, "block_positions": pos})
        jout, pout = both_forwards(target, block, caches, 9, layers, **masks)
    else:
        lens = np.asarray([9, 13])
        padded = np.zeros((2, 13), np.int64)
        padded[0, :9] = rng.integers(0, V, size=9)
        padded[1] = rng.integers(0, V, size=13)
        caches = prefill_both(target, padded)
        valid = np.ones((2, 64), bool)
        valid[1, :2] = False  # two left-pad slots of row 1
        block = rng.integers(0, V, size=(2, 5))
        masks = {"prefix_valid": valid}
        if mode == "per_row_tree":
            masks.update(block_allow=allow, block_positions=pos)
        elif mode == "per_row_beam":
            masks.update(block_allow=np.stack([allow, allow.T | np.eye(
                5, dtype=bool)]), block_positions=pos)
        jout, pout = both_forwards(target, block, caches, lens, layers,
                                   **masks)
    for got, want in zip(pout, jout):
        assert_close(got, want)


@pytest.mark.parametrize("per_row", [False, True])
def test_draft_step_matches_jax(random_draft, per_row):
    """The cached draft step: next hidden, logits and caches at 1e-5, at a
    scalar length and at per-row lengths with a pad mask."""
    module, variables, draft = random_draft
    rng = np.random.default_rng(1)
    b, t, m = (2, 3, 32) if per_row else (1, 7, 32)
    ids = rng.integers(0, V, size=(b, t))
    hidden = rng.normal(size=(b, t, H)).astype(np.float32)
    ck = rng.normal(size=(b, 2, m, 8)).astype(np.float32)
    cv = rng.normal(size=(b, 2, m, 8)).astype(np.float32)
    clen = np.asarray([4, 9]) if per_row else np.asarray(3)
    valid = (np.arange(m)[None] >= (1 if per_row else 0)) & np.ones(
        (b, m), bool)
    kwargs = {"prefix_valid": valid} if per_row else {}
    jout = jax_sd._draft_step(
        variables, module, jnp.asarray(ids, jnp.int32), jnp.asarray(hidden),
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(clen, jnp.int32),
        **{k: jnp.asarray(v) for k, v in kwargs.items()})
    pout = spec_decode._draft_step(
        draft, torch.as_tensor(ids), torch.as_tensor(hidden),
        torch.as_tensor(ck), torch.as_tensor(cv), torch.as_tensor(clen),
        **{k: torch.as_tensor(v) for k, v in kwargs.items()})
    for got, want in zip(pout, jout):
        assert_close(got, want)


# --------------------------------------------------------------------------
# plain greedy decoding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["free", "budget", "stop", "stop_first"])
def test_plain_decoders_match_jax(target, case):
    """``greedy_target_decode`` and ``fused_plain_decode`` token for token
    against JAX's: free decoding, the cache-budget guard (a prompt of 10 in
    a budget of 24 asked for 40 tokens), a stop token mid-run, and a stop
    on the first token."""
    jparams, jcfg, pparams, pcfg = target
    prompt = list(range(3, 13))
    max_len, max_new = (24, 40) if case == "budget" else (64, 20)
    free = jax_sd.greedy_target_decode(jparams, jcfg, prompt, 20,
                                       capture_layers=(1,), max_len=64)
    stop = {"stop": [int(free[len(prompt) + 5])],
            "stop_first": [int(free[len(prompt)])]}.get(case)
    want = jax_sd.fused_plain_decode(jparams, jcfg, prompt, max_new,
                                     max_len=max_len, stop_token_ids=stop)
    got = spec_decode.fused_plain_decode(pparams, pcfg, prompt, max_new,
                                         max_len=max_len, stop_token_ids=stop)
    np.testing.assert_array_equal(got, want)
    if case == "budget":
        assert len(got) == max_len  # the guard stopped the run
        return
    greedy = spec_decode.greedy_target_decode(
        pparams, pcfg, prompt, max_new, capture_layers=(1,), max_len=64,
        stop_token_ids=stop)
    np.testing.assert_array_equal(greedy, jax_sd.greedy_target_decode(
        jparams, jcfg, prompt, max_new, capture_layers=(1,), max_len=64,
        stop_token_ids=stop))
    np.testing.assert_array_equal(got, greedy)
    if case == "stop_first":
        assert len(got) == len(prompt) + 1


# --------------------------------------------------------------------------
# the chain decoder
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoders():
    """(JAX's decoder, the port's) for a target, draft and k, built once
    (a JAX decoder compiles its own draft steps)."""
    built = {}

    def get(target, draft, k, layers):
        key = (id(target[0]), id(draft[2]), k)
        if key not in built:
            jparams, jcfg, module, variables = target[:2] + draft[:2]
            pparams, pcfg = target[2:]
            built[key] = (
                jax_sd.Eagle3SpecDecoder(jparams, jcfg, module, variables,
                                         capture_layers=layers,
                                         num_draft_tokens=k, max_len=256),
                spec_decode.Eagle3SpecDecoder(
                    pparams, pcfg, draft[2], capture_layers=layers,
                    num_draft_tokens=k, max_len=256, device="cpu"))
        return built[key]

    return get


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.output_ids, want.output_ids)
    assert got.accept_lengths == [int(a) for a in want.accept_lengths]
    assert got.steps == want.steps


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("which", ["random", "trained"])
def test_chain_decoder_matches_jax(request, target, decoders, which, k):
    """``generate`` and ``generate_fused`` against JAX's host loop: the
    same output ids and accept lengths, the fused rounds equal to the host
    loop, and the target's greedy output (the invariant). The trained draft
    accepts more than 1.5 tokens a round on average, with rounds of
    partial acceptance (1 < a < k + 1)."""
    if which == "random":
        draft = request.getfixturevalue("random_draft")
        layers = (1, 2, 3)
        prompts = [np.random.default_rng(1).integers(0, V, size=12).tolist()]
    else:
        bundle = request.getfixturevalue("trained")
        target = bundle["jax"][:2] + bundle["port"][:2]
        draft = bundle["jax"][2:] + bundle["port"][2:]
        layers = (1, 2, 2)
        prompts = bundle["prompts"]
    jdec, pdec = decoders(target, draft, k, layers)
    accepts = []
    for prompt in prompts:
        want = jdec.generate(prompt, max_new_tokens=24)
        host = pdec.generate(prompt, max_new_tokens=24)
        fused = pdec.generate_fused(prompt, max_new_tokens=24)
        assert_same_result(host, want)
        assert_same_result(fused, want)
        greedy = spec_decode.greedy_target_decode(
            target[2], target[3], prompt, 24, max_len=256)
        n = min(len(greedy), len(host.output_ids))
        np.testing.assert_array_equal(host.output_ids[:n], greedy[:n])
        accepts += host.accept_lengths
    if which == "trained":
        assert np.mean(accepts) > 1.5
        assert any(1 < a < k + 1 for a in accepts)
    assert pdec._fused.replays == 0  # no graphs on the CPU


@pytest.mark.parametrize("k", [2, 4])
def test_chain_stop_tokens_match_jax(trained, decoders, k):
    """A stop token the target emits mid-run: the port's host loop and
    fused rounds stop where JAX's fused loop stops."""
    target = trained["jax"][:2] + trained["port"][:2]
    draft = trained["jax"][2:] + trained["port"][2:]
    jdec, pdec = decoders(target, draft, k, (1, 2, 2))
    prompt = trained["prompts"][0]
    free = pdec.generate(prompt, max_new_tokens=24)
    emitted = [int(t) for t in free.output_ids[len(prompt) + 1:]]
    stop = [emitted[len(emitted) // 2]]
    want = jdec.generate_fused(prompt, max_new_tokens=24,
                               stop_token_ids=stop)
    assert_same_result(pdec.generate(prompt, 24, stop_token_ids=stop), want)
    assert_same_result(pdec.generate_fused(prompt, 24, stop_token_ids=stop),
                       want)
    assert len(want.output_ids) < len(free.output_ids)


def test_stop_sets_share_one_program(trained, decoders):
    """Requests with other stop sets reuse one fused program and its
    caches (the stop set is data, in a buffer padded with -1), and stop
    where the host loop and greedy decoding stop; more than
    ``STOP_SLOTS`` stop ids raise."""
    target = trained["jax"][:2] + trained["port"][:2]
    draft = trained["jax"][2:] + trained["port"][2:]
    _, pdec = decoders(target, draft, 2, (1, 2, 2))
    params, config = trained["port"][:2]
    prompt = trained["prompts"][1]
    emitted = [int(t) for t in pdec.generate(prompt, 24).output_ids]
    loops = {}
    for stop in ([emitted[-12]], [emitted[-6], V - 1], []):
        assert_same_result(pdec.generate_fused(prompt, 24, stop_token_ids=stop),
                           pdec.generate(prompt, 24, stop_token_ids=stop))
        np.testing.assert_array_equal(
            spec_decode.fused_plain_decode(params, config, prompt, 24,
                                           max_len=64, stop_token_ids=stop,
                                           loop_cache=loops),
            spec_decode.greedy_target_decode(params, config, prompt, 24,
                                             max_len=64,
                                             stop_token_ids=stop))
    assert list(pdec._fused._cache) == [("chain", 256)]
    assert len(loops) == 1
    too_many = range(spec_decode.STOP_SLOTS + 1)
    with pytest.raises(ValueError, match="at most"):
        pdec.generate_fused(prompt, 4, stop_token_ids=too_many)
    with pytest.raises(ValueError, match="at most"):
        spec_decode.fused_plain_decode(params, config, prompt, 4, max_len=64,
                                       stop_token_ids=too_many)


# --------------------------------------------------------------------------
# the export loader
# --------------------------------------------------------------------------

def jax_export(tmp_path, monkeypatch, random_draft, fmt):
    """The random draft exported by JAX's exporter (the SGLang layout
    without the frozen embedding; the HF layout with a target's) → (the
    directory, the target's embedding)."""
    from specforge_tpu.export import exporter as jax_exporter
    from tests.test_torch_export import write_embedding_source

    _, variables, _ = random_draft
    params = dict(variables["params"])
    params.pop("embed_tokens")
    state = {"params": {"draft_model": params},
             "buffers": {"draft_model": variables["buffers"]}}
    monkeypatch.setattr(
        jax_exporter, "load_training_state",
        lambda _ckpt: (state, {"contract": {"strategy": "eagle3"}}))
    draft_config = tmp_path / "draft.json"
    draft_config.write_text(json.dumps(
        {**DRAFT_KW, "architectures": ["LlamaForCausalLMEagle3"]}))
    source = write_embedding_source(tmp_path / "target", V, H)
    out = str(tmp_path / "jax")
    jax_exporter.export_checkpoint(
        "unused", out, fmt, draft_config_path=str(draft_config),
        **({"embedding_source": source} if fmt == "hf" else {}))
    tensors, _ = load_feature_file(os.path.join(source, "model.safetensors"))
    return out, tensors["model.embed_tokens.weight"].float()


def assert_loaders_agree(export, embed):
    """The port's loader against JAX's, bit for bit in bf16."""
    draft = serving_loaders.load_exported_draft(export, embed, device="cpu")
    _, variables = jax_loaders.load_exported_draft(
        export, fallback_embedding=embed.numpy())
    want = params_from_jax(jax.device_get(variables))
    got = draft.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in got.items():
        if value.is_floating_point():
            assert value.dtype == torch.bfloat16, name
            assert torch.equal(value.float(), want[name]), name
        else:
            assert torch.equal(value, want[name].to(value.dtype)), name
    return draft


@pytest.mark.parametrize("fmt", ["sglang", "hf"])
@pytest.mark.parametrize("source", ["jax", "port"])
def test_load_exported_draft_matches_jax(request, tmp_path, monkeypatch,
                                         source, fmt):
    """A JAX-exported and a port-exported SGLang and HF directory load
    bit-identically in bf16 in both packages; the SGLang layout takes the
    target's embedding, the HF layout its own."""
    if source == "jax":
        export, embed = jax_export(tmp_path, monkeypatch,
                                   request.getfixturevalue("random_draft"),
                                   fmt)
    else:
        trained = request.getfixturevalue("trained")
        embed = trained["port"][0]["model.embed_tokens.weight"]
        export = trained["export"]
        if fmt == "hf":
            export = str(tmp_path / "hf")
            export_to_hf(trained["runs"], export,
                         draft_config_path=trained["draft_config"],
                         embedding_source=trained["target"], device="cpu")
    draft = assert_loaders_agree(export, embed)
    if fmt == "sglang":
        assert torch.equal(draft.embed_tokens.weight,
                           embed.to(torch.bfloat16))


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_load_exported_draft_missing_embedding_errors(trained, fault):
    """An SGLang export with no fallback embedding, or one of the wrong
    shape: both packages raise the same error."""
    embed = trained["port"][0]["model.embed_tokens.weight"]
    fallback = None if fault == "missing" else embed[:-1]
    match = ("no embedding and no fallback" if fault == "missing" else
             r"fallback embedding shape \(127, 32\) vs model \(128, 32\)")
    with pytest.raises(ValueError, match=match):
        serving_loaders.load_exported_draft(trained["export"], fallback,
                                            device="cpu")
    with pytest.raises(ValueError, match=match):
        jax_loaders.load_exported_draft(
            trained["export"],
            fallback_embedding=None if fallback is None else
            fallback.numpy())


def test_serving_loaders_build_the_decoder(trained):
    """``load_spec_models`` + ``build_decoder`` (the default capture
    layers (1, n//2-1, n-4)) serve the export as the fixture's decoder
    does."""
    models = serving_loaders.load_spec_models(
        trained["target"], trained["export"], dtype=torch.float32,
        device="cpu")
    decoder = serving_loaders.build_decoder(models, num_draft_tokens=3,
                                            max_len=128, device="cpu")
    assert decoder.capture_layers == (1, 2, 2)
    assert models[2].embed_tokens.weight.dtype == torch.bfloat16
    prompt = trained["prompts"][1]
    got = decoder.generate_fused(prompt, max_new_tokens=16)
    greedy = spec_decode.greedy_target_decode(models[0], models[1], prompt,
                                              16, max_len=128)
    np.testing.assert_array_equal(got.output_ids[:len(greedy)], greedy)


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("call,item", [
    ("generate_topk", "item 8c"), ("fused_topk", "item 8c"),
    ("fused_beam", "item 8c"), ("batch", "item 8d"), ("stream", "item 8d"),
    ("mesh", "item 8e"), ("block_mesh", "item 8e"),
    ("peagle_export", "item 8b"), ("peagle_draft", "item 8b")])
def test_refusals_name_their_item(target, random_draft, tmp_path, call,
                                  item):
    """What the port does not serve yet raises a ValueError naming its
    ``ROADMAP.md`` item: tree and beam speculation (8c), the batched and
    streamed decoders (8d), a device mesh under either decoder (8e), and
    P-EAGLE exports and drafts (8b). DFlash-family exports load and serve
    (``tests/test_torch_serving_dflash.py``)."""
    _, _, pparams, pcfg = target
    draft = random_draft[2]

    def decoder(**kwargs):
        return spec_decode.Eagle3SpecDecoder(
            pparams, pcfg, draft, capture_layers=(1, 2, 3),
            num_draft_tokens=2, max_len=64, device="cpu", **kwargs)

    def export(config):
        os.makedirs(tmp_path / "export", exist_ok=True)
        (tmp_path / "export" / "config.json").write_text(json.dumps(config))
        return str(tmp_path / "export")

    calls = {
        "generate_topk": lambda: decoder().generate([1, 2], 4, topk=2),
        "fused_topk": lambda: decoder().generate_fused([1, 2], 4, topk=2),
        "fused_beam": lambda: decoder().generate_fused([1, 2], 4,
                                                       tree_style="beam"),
        "batch": lambda: decoder().generate_batch_fused([[1, 2]], 4),
        "stream": lambda: decoder().generate_stream_fused([[1, 2]], 4),
        "mesh": lambda: decoder(mesh=object()),
        "block_mesh": lambda: serving_loaders.build_decoder(
            (pparams, pcfg, DominoDraftModel(DFlashConfig.from_dict(
                {**DRAFT_KW, "num_hidden_layers": 1, "block_size": 4,
                 "dflash_config": {"projector_type": "domino",
                                   "target_layer_ids": [1, 4], "emb_dim": 8,
                                   "gru_hidden_dim": 8}}),
                device="cpu")), mesh=object(), device="cpu"),
        "peagle_export": lambda: serving_loaders.load_exported_draft(
            export({**DRAFT_KW, "architectures": ["PEagleDraftModel"]}),
            device="cpu"),
        "peagle_draft": lambda: serving_loaders.build_decoder(
            (pparams, pcfg, PEagleDraftModel(PEagleConfig(**DRAFT_KW),
                                             device="cpu")), device="cpu"),
    }
    with pytest.raises(ValueError, match=item):
        calls[call]()


def test_serving_takes_dense_targets_only(target):
    """An MLA or MoE target is refused before any forward."""
    import dataclasses

    pcfg = target[3]
    for changed in (dict(attn_variant="mla"), dict(num_experts=4,
                                                   num_experts_per_tok=2)):
        cfg = dataclasses.replace(pcfg, **changed)
        with pytest.raises(ValueError, match="dense target"):
            spec_decode.check_dense_target(cfg)
    spec_decode.check_dense_target(pcfg)
