"""The PyTorch port's DSpark draft family against the JAX package, on the
CPU.

Small shapes (vocab 2048, hidden 128, 4 heads over 2 kv heads of 32, 2
layers, S 24, blocks of 4, 4 anchors, Markov rank 8) in fp32, with numpy
inputs from a seed handed to both sides. Weights cross over through
``params_from_jax``, and the port is handed the anchors the JAX sampler
drew. The JAX models run their ``"chunked"`` attention (its tests hold it
equal to the Pallas kernel) except in the block-size-7 case, which runs the
Pallas kernel in interpret mode; the port runs its kernel path, whose
wrappers take their plain versions on CPU tensors. The tolerances are those
of ``tests/test_dflash_family.py`` (fused against unfused DSpark): loss
rtol 1e-5 / atol 1e-7, ratio metrics 1e-4 / 1e-6, gradients 5e-4 / 1e-5."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.algorithms.common.dflash_family import (
    OnlineDSparkModel as JaxOnlineDSparkModel,
)
from specforge_tpu.models.draft.dflash import DFlashConfig as JaxDFlashConfig
from specforge_tpu.models.draft.dflash import (
    build_target_layer_ids as jax_build_target_layer_ids,
)
from specforge_tpu.models.draft.dspark import (
    AcceptRatePredictor as JaxAcceptRatePredictor,
)
from specforge_tpu.models.draft.dspark import (
    DSparkDraftModel as JaxDSparkDraft,
)
from specforge_tpu.models.draft.dspark import GatedMarkovHead as JaxGated
from specforge_tpu.models.draft.dspark import RNNMarkovHead as JaxRNN
from specforge_tpu.models.draft.dspark import VanillaMarkovHead as JaxVanilla
from specforge_tpu.ops import fused_objective as jax_fo
from specforge_tpu.ops import masks as jax_masks
from specforge_tpu_torch import cli
from specforge_tpu_torch.application.composition import build_training_run
from specforge_tpu_torch.algorithms.common.dflash_family import (
    OnlineDSparkModel,
)
from specforge_tpu_torch.config.schema import load_config
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.models.draft.dflash import DFlashConfig
from specforge_tpu_torch.models.draft.dspark import (
    AcceptRatePredictor,
    DSparkDraftModel,
    GatedMarkovHead,
    RNNMarkovHead,
    VanillaMarkovHead,
)
from specforge_tpu_torch.ops import fused_objective as fo
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    save_feature_file,
)

V, H, S, BS, N_ANCHORS, LAYERS, R = 2048, 128, 24, 4, 4, 2, 8
MASK_TOKEN = V - 1
BASE_CFG = dict(
    vocab_size=V, hidden_size=H, intermediate_size=256,
    num_attention_heads=4, num_key_value_heads=2, head_dim=32,
    num_hidden_layers=LAYERS, num_target_layers=8, block_size=BS,
    mask_token_id=MASK_TOKEN, max_position_embeddings=128,
    projector_type="dspark",
)
LOSS = dict(rtol=1e-5, atol=1e-7)     # test_dflash_family.py:460
RATIO = dict(rtol=1e-4, atol=1e-6)    # test_dflash_family.py:464-466
GRAD = dict(rtol=5e-4, atol=1e-5)     # test_dflash_family.py:470
METRICS = ("acc", "ce_loss", "l1_loss", "confidence_loss",
           "confidence_abs_error", "teacher_agreement", "teacher_top1_prob",
           "draft_top1_prob", "tau_probabilistic")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per test worker (see test_torch_train.py's
    fixture of the same name: the default oversubscribes a shared CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), **tol)


# --------------------------------------------------------------------------
# the heads
# --------------------------------------------------------------------------

def _head_inputs(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(2, 3, BS, V)).astype(np.float32)
    ids = rng.integers(0, V, size=(2, 3, BS)).astype(np.int32)
    hidden = rng.normal(size=(2, 3, BS, H)).astype(np.float32)
    ct = rng.normal(size=(2, 3, BS, V)).astype(np.float32)
    return base, ids, hidden, ct


@pytest.mark.parametrize("kind", ["vanilla", "gated", "rnn"])
def test_markov_heads_match_jax(kind):
    """Each Markov head's biased logits and their gradients to the head's
    parameters and to the hidden state."""
    jax_cls = {"vanilla": JaxVanilla, "gated": JaxGated, "rnn": JaxRNN}[kind]
    port_cls = {"vanilla": VanillaMarkovHead, "gated": GatedMarkovHead,
                "rnn": RNNMarkovHead}[kind]
    base, ids, hidden, ct = _head_inputs()
    jhead = jax_cls(vocab_size=V, markov_rank=R, hidden_size=H,
                    dtype=jnp.float32)

    def jax_fn(params, x):
        return jhead.apply({"params": params}, jnp.asarray(base),
                           token_ids=jnp.asarray(ids), hidden_states=x,
                           method=jax_cls.apply_block_logits)

    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(base),
                        token_ids=jnp.asarray(ids),
                        hidden_states=jnp.asarray(hidden),
                        method=jax_cls.apply_block_logits)["params"]
    ref = jax_fn(params, jnp.asarray(hidden))
    ref_grads, ref_dx = jax.grad(
        lambda p, x: jnp.sum(jax_fn(p, x) * ct), argnums=(0, 1))(
            params, jnp.asarray(hidden))

    head = port_cls(V, R, H, torch.float32)
    head.load_state_dict(params_from_jax(jax.device_get({"params": params})))
    x = torch.tensor(hidden, requires_grad=True)
    out = head.apply_block_logits(t(base), token_ids=t(ids), hidden_states=x)
    (out * t(ct)).sum().backward()
    close(out.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    # the vanilla head does not read the hidden state
    dx = torch.zeros_like(x) if x.grad is None else x.grad
    close(dx.numpy(), ref_dx, **GRAD)
    ref_grads = params_from_jax(jax.device_get({"params": ref_grads}))
    assert set(ref_grads) == {n for n, _ in head.named_parameters()}
    for name, p in head.named_parameters():
        close(p.grad.numpy(), ref_grads[name].numpy(), err_msg=name, **GRAD)


def test_accept_rate_predictor_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, BS, H)).astype(np.float32)
    jhead = JaxAcceptRatePredictor(dtype=jnp.float32)
    params = jhead.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    head = AcceptRatePredictor(H, torch.float32)
    head.load_state_dict(params_from_jax({"params": jax.device_get(params)}))
    close(head(t(x)).detach().numpy(),
          jhead.apply({"params": params}, jnp.asarray(x)), rtol=1e-5,
          atol=1e-6)


@pytest.mark.parametrize("with_markov", [False, True])
def test_confidence_head_matches_jax(with_markov):
    """The draft's confidence logits, from the hidden state alone or
    concatenated with the previous token's Markov embedding."""
    extra = dict(markov_rank=R, enable_confidence_head=True,
                 confidence_head_with_markov=with_markov)
    rng = np.random.default_rng(2)
    hidden = rng.normal(size=(2, 3, BS, H)).astype(np.float32)
    ids = rng.integers(0, V, size=(2, 3, BS)).astype(np.int32)
    jdraft = JaxDSparkDraft(JaxDFlashConfig.from_dict({**BASE_CFG, **extra}),
                            dtype=jnp.float32)
    args = (jnp.asarray(hidden),)
    kwargs = {"prev_token_ids": jnp.asarray(ids)}
    params = jdraft.init(jax.random.PRNGKey(0), *args, **kwargs,
                         method=JaxDSparkDraft.predict_confidence)
    ref = jdraft.apply(params, *args, **kwargs,
                       method=JaxDSparkDraft.predict_confidence)
    draft = DSparkDraftModel(DFlashConfig.from_dict({**BASE_CFG, **extra}),
                             dtype=torch.float32, device="cpu")
    missing, unexpected = draft.load_state_dict(
        params_from_jax(jax.device_get(params)), strict=False)
    assert not unexpected
    assert "confidence_head.proj.weight" not in missing
    assert ("markov_head.markov_w1.weight" in missing) != with_markov
    got = draft.predict_confidence(t(hidden), prev_token_ids=t(ids))
    assert got.shape == (2, 3, BS)
    close(got.detach().numpy(), ref, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the fused objective
# --------------------------------------------------------------------------

def _objective_inputs(seed=4):
    rng = np.random.default_rng(seed)
    b, n = 2, 4
    hidden = rng.normal(size=(b, n, BS, H)).astype(np.float32)
    latent = rng.normal(size=(b, n, BS, R)).astype(np.float32)
    w2 = (rng.normal(size=(R, V)) * 0.3).astype(np.float32)
    ath = rng.normal(size=(b, n, BS, H)).astype(np.float32)
    targets = rng.integers(0, V, size=(b, n, BS)).astype(np.int32)
    em = np.cumprod(rng.random((b, n, BS)) > 0.15, axis=-1).astype(bool)
    lw = em * np.exp(-np.arange(BS) / 3.0).astype(np.float32)
    head = (rng.normal(size=(V, H)) * 0.3).astype(np.float32)
    return hidden, latent, w2, ath, targets, lw.astype(np.float32), em, head


@pytest.mark.parametrize("has_target", [True, False])
@pytest.mark.parametrize("has_markov", [True, False])
def test_fused_dspark_objective_matches_jax(has_markov, has_target):
    """All fourteen outputs (the acceptance probability included) and the
    gradients of vocab_num to hidden, latent and w2."""
    hidden, latent, w2, ath, targets, lw, em, head = _objective_inputs()
    if not has_markov:
        latent = np.zeros((*hidden.shape[:3], 1), np.float32)
        w2 = np.zeros((1, 1), np.float32)
    jath = ath if has_target else np.zeros((*hidden.shape[:3], 1), np.float32)
    opts = jax_fo._DSparkOpts(chunk_blocks=2, ce_alpha=0.1, l1_alpha=0.9,
                              has_markov=has_markov, has_target=has_target)

    def jax_fn(x, lat, w):
        return jax_fo.dspark_objective_fused(
            x, lat, w, jnp.asarray(jath), jnp.asarray(targets),
            jnp.asarray(lw), jnp.asarray(em), jnp.asarray(head), opts)

    args = (jnp.asarray(hidden), jnp.asarray(latent), jnp.asarray(w2))
    ref = jax_fn(*args)
    ref_grads = jax.grad(lambda *a: jax_fn(*a)[0], argnums=(0, 1, 2))(*args)

    x = torch.tensor(hidden, requires_grad=True)
    lat = torch.tensor(latent, requires_grad=True) if has_markov else None
    w2_t = torch.tensor(w2.T.copy(), requires_grad=True) if has_markov else None
    outs = fo.dspark_objective_fused(
        x, lat, w2_t, t(ath) if has_target else None, t(targets), t(lw),
        t(em), t(head), 0.1, 0.9, 2)
    assert len(outs) == len(ref) == 14
    outs[0].backward()
    for i, (a, r) in enumerate(zip(outs, ref)):
        close(a.detach().numpy(), r, err_msg=f"output {i}", **RATIO)
    close(float(outs[0].detach()), float(ref[0]), **LOSS)
    close(x.grad.numpy(), ref_grads[0], err_msg="hidden", **GRAD)
    if has_markov:
        close(lat.grad.numpy(), ref_grads[1], err_msg="latent", **GRAD)
        close(w2_t.grad.numpy(), np.asarray(ref_grads[2]).T, err_msg="w2",
              **GRAD)


# --------------------------------------------------------------------------
# the training model
# --------------------------------------------------------------------------

def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    n_capture = len(jax_build_target_layer_ids(8, LAYERS))
    tensors = {
        "input_ids": rng.integers(0, V - 1, size=(2, S)).astype(np.int32),
        "hidden_states": rng.normal(size=(2, S, n_capture * H)).astype(
            np.float32),
        "loss_mask": (rng.random((2, S)) > 0.2).astype(np.int32),
        "target_last_hidden_states": rng.normal(size=(2, S, H)).astype(
            np.float32),
    }
    frozen = {
        "target_head_weight": (rng.normal(size=(V, H)) * 0.3).astype(
            np.float32),
        "target_embed_weight": (rng.normal(size=(V, H)) * 0.3).astype(
            np.float32),
    }
    return tensors, frozen


def _models(extra, jax_backend, bs=BS, **kwargs):
    jcfg = JaxDFlashConfig.from_dict({**BASE_CFG, "block_size": bs, **extra})
    common = dict(mask_token_id=MASK_TOKEN, block_size=bs,
                  num_anchors=N_ANCHORS, objective_chunk_blocks=2, **kwargs)

    def jax_model(backend):
        draft = JaxDSparkDraft(jcfg, dtype=jnp.float32, attn_chunk_blocks=2,
                               attention_backend=backend)
        return JaxOnlineDSparkModel(draft_model=draft, **common)

    cfg = DFlashConfig.from_dict({**BASE_CFG, "block_size": bs, **extra})
    draft = DSparkDraftModel(cfg, dtype=torch.float32,
                             attention_backend="pallas", attn_chunk_blocks=2,
                             device="cpu")
    return jax_model(jax_backend), jax_model("chunked"), OnlineDSparkModel(
        draft, **common)


def _random_variables(jinit, args, seed=1):
    """The JAX model's parameter tree (traced, not compiled: its init
    compile costs seconds) filled from numpy: fan-in-scaled kernels and
    embeddings, norm weights near 1, small biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jinit.init, jax.random.PRNGKey(1), *args)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['weight']"):
            x = 1.0 + 0.1 * rng.normal(size=leaf.shape)
        elif name.endswith("['bias']"):
            x = 0.1 * rng.normal(size=leaf.shape)
        else:  # a kernel [in, out] or an embedding [V, r]
            x = rng.normal(size=leaf.shape) * leaf.shape[-2] ** -0.5
        return jnp.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _compare(extra, jax_backend="chunked", with_target=True, bs=BS,
             **kwargs):
    """Loss, accuracy, every ratio metric and every parameter gradient of
    the JAX model and the port's from the same weights and anchors."""
    tensors, frozen = _inputs()
    jmodel, jinit, model = _models(extra, jax_backend, bs, **kwargs)
    rng_key = jax.random.PRNGKey(3)
    args = [jnp.asarray(tensors[k]) for k in
            ("input_ids", "hidden_states", "loss_mask")]
    args += [jnp.asarray(frozen["target_head_weight"]),
             jnp.asarray(frozen["target_embed_weight"]), rng_key]
    if with_target:
        args.append(jnp.asarray(tensors["target_last_hidden_states"]))
    variables = _random_variables(jinit, args)

    def run(params):
        loss, acc, metrics = jmodel.apply({"params": params}, *args)
        return loss, (acc, metrics)

    (jloss, (jacc, jmetrics)), jgrads = jax.jit(jax.value_and_grad(
        run, has_aux=True))(variables["params"])

    model.load_state_dict(params_from_jax(jax.device_get(variables)))
    positions, keep = jax_masks.sample_anchor_positions(
        rng_key, jnp.asarray(tensors["loss_mask"]), N_ANCHORS)
    pargs = [t(tensors[k]) for k in ("input_ids", "hidden_states",
                                     "loss_mask")]
    pargs += [t(frozen["target_head_weight"]),
              t(frozen["target_embed_weight"]), None]
    if with_target:
        pargs.append(t(tensors["target_last_hidden_states"]))
    loss, acc, metrics = model(*pargs, anchors=(t(positions), t(keep)))
    loss.backward()
    close(float(loss.detach()), float(jloss), **LOSS)
    close(float(acc), float(jacc), rtol=1e-6)
    assert set(metrics["ratio_metrics"]) == set(METRICS)
    for key in METRICS:
        (num, den), (jnum, jden) = (metrics["ratio_metrics"][key],
                                    jmetrics["ratio_metrics"][key])
        close(float(num), float(jnum), err_msg=key, **RATIO)
        close(float(den), float(jden), rtol=1e-6, err_msg=key)
    ref = params_from_jax(jax.device_get({"params": jgrads}))
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    for name, p in grads.items():
        close(p.grad.numpy(), ref[name].numpy(), err_msg=name, **GRAD)
    return metrics


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("markov_type", ["vanilla", "gated", "rnn"])
def test_dspark_model_matches_jax(markov_type, fused):
    extra = dict(markov_rank=R, markov_head_type=markov_type,
                 enable_confidence_head=True,
                 confidence_head_with_markov=markov_type == "vanilla")
    metrics = _compare(extra, loss_decay_gamma=3.0, fused_objective=fused)
    assert float(metrics["ratio_metrics"]["confidence_loss"][0]) > 0


@pytest.mark.parametrize("fused", [True, False])
def test_dspark_no_markov_no_target_matches_jax(fused):
    """Without a Markov head and without the teacher's hidden states the
    objective is the CE alone (test_dflash_family.py:473)."""
    metrics = _compare(dict(markov_rank=0), with_target=False,
                       dspark_l1_loss_alpha=0.0,
                       dspark_confidence_head_alpha=0.0,
                       fused_objective=fused)
    assert float(metrics["ratio_metrics"]["l1_loss"][0]) == 0.0


def test_dspark_block_size_7_matches_jax_pallas_interpret():
    """Blocks of 7 (DSpark's configs): the JAX side on its Pallas kernel in
    interpret mode, the port on its kernel path (the pitched kernels on the
    card, their plain versions here)."""
    extra = dict(markov_rank=R, markov_head_type="vanilla",
                 enable_confidence_head=True,
                 confidence_head_with_markov=True)
    _compare(extra, jax_backend="pallas_interpret", bs=7,
             loss_decay_gamma=4.0)


def test_confidence_loss_needs_the_teacher():
    extra = dict(markov_rank=R, enable_confidence_head=True)
    tensors, frozen = _inputs()
    _, _, model = _models(extra, "chunked")
    with pytest.raises(ValueError, match="target_last_hidden_states"):
        model(t(tensors["input_ids"]), t(tensors["hidden_states"]),
              t(tensors["loss_mask"]), t(frozen["target_head_weight"]),
              t(frozen["target_embed_weight"]), torch.Generator())


# --------------------------------------------------------------------------
# cli train
# --------------------------------------------------------------------------

def _write_run(tmp_path) -> str:
    """Feature files with ``target_last_hidden_states``, a random target
    directory and a run JSON of ``strategy: dspark`` (a gated Markov head
    and a confidence head) → the run JSON's path."""
    rng = np.random.default_rng(0)
    n_capture = len(jax_build_target_layer_ids(8, LAYERS))
    data = tmp_path / "train"
    data.mkdir()
    for i in range(4):
        seq = int(rng.integers(16, S + 1))
        loss_mask = np.zeros(seq, np.int64)
        loss_mask[seq // 4:] = 1
        save_feature_file(str(data / f"sample-{i:04d}.sft"), {
            "input_ids": t(rng.integers(0, V, size=(seq,))),
            "loss_mask": t(loss_mask),
            "hidden_states": t(rng.normal(size=(seq, n_capture * H))).to(
                torch.bfloat16),
            "target_last_hidden_states": t(rng.normal(size=(seq, H))).to(
                torch.bfloat16),
        }, {"target_repr": "hidden_state"})
    target = tmp_path / "target"
    target.mkdir()
    save_feature_file(str(target / "model.safetensors"), {
        "lm_head.weight": t(rng.normal(size=(V, H)) * 0.1).to(torch.bfloat16),
        "model.embed_tokens.weight": t(rng.normal(size=(V, H))).to(
            torch.bfloat16)})
    (target / "config.json").write_text(json.dumps(
        {"vocab_size": V, "hidden_size": H, "tie_word_embeddings": False}))
    run = {
        "run_id": "dspark", "output_dir": str(tmp_path / "runs"),
        "model": {"target_model_path": str(target),
                  "draft_config": {**BASE_CFG, "markov_rank": R,
                                   "markov_head_type": "gated",
                                   "enable_confidence_head": True},
                  "compute_dtype": "float32"},
        "data": {"train_data_path": str(data), "max_length": S,
                 "num_workers": 0},
        "training": {"strategy": "dspark", "batch_size": 2, "num_epochs": 1,
                     "num_anchors": N_ANCHORS, "objective_chunk_blocks": 2,
                     "log_interval": 1},
        "tracking": {"backend": "jsonl"},
    }
    path = tmp_path / "run.json"
    path.write_text(json.dumps(run))
    return str(path)


def test_cli_trains_dspark_on_the_cpu(tmp_path):
    """``strategy: dspark`` through ``cli train --device cpu``: two
    optimizer steps over feature files with ``target_last_hidden_states``,
    finite values of all nine ratio metrics, and the checkpoint."""
    path = _write_run(tmp_path)
    assert cli.main(["train", "-c", path, "--device", "cpu"]) == 0
    records = [json.loads(line) for line in
               (tmp_path / "runs" / "dspark.metrics.jsonl").read_text()
               .splitlines()]
    steps = [r for r in records if "train/loss" in r]
    assert len(steps) == 2
    for r in steps:
        for key in ("loss", "grad_norm", *METRICS):
            assert np.isfinite(r[f"train/{key}"]), key
    assert (tmp_path / "runs" / "dspark-step2" / "state" / "state.pt").exists()


def test_dspark_refuses_an_eval_pass(tmp_path):
    """The JAX strategies of the family define no eval pass, DSpark's
    neither: an eval set is refused by name."""
    config = load_config(_write_run(tmp_path), ['data.eval_data_path="eval"'])
    with pytest.raises(NotImplementedError, match="eval pass.*dspark"):
        build_training_run(config, device="cpu")
