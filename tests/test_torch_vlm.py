"""The port's mrope data path against the JAX package, on the CPU.

``data/vlm.py`` (3-D position ids and vision spans) integer for integer,
the collator's [3, S] padding, and an mrope EAGLE3 draft (hidden 128, 4
heads, 2 kv heads, head dim 32 in sections [4, 6, 6], S 64, vocab 2048,
draft vocab 512, TTT 7) in fp32: one optimizer step of the compact-teacher
strategy on a batch with a vision sample's [B, 3, S] position ids, and its
eval sums, as ``tests/test_vlm.py::test_mrope_training_forward`` runs the
model, at ``tests/test_torch_train.py``'s tolerance (rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.algorithms.eagle3.model import (
    OnlineEagle3Model as JaxOnlineEagle3Model,
)
from specforge_tpu.data import vlm as jax_vlm
from specforge_tpu.data.collator import CollatorConfig as JaxCollatorConfig
from specforge_tpu.data.collator import PaddingCollator as JaxPaddingCollator
from specforge_tpu.models.draft.llama_eagle3 import (
    Eagle3Config as JaxEagle3Config,
)
from specforge_tpu.models.draft.llama_eagle3 import LlamaEagle3Draft as JaxDraft
from specforge_tpu.training import optimizer as jax_opt
from specforge_tpu.training.strategies import (
    Eagle3TrainStrategy as JaxEagle3TrainStrategy,
)
from specforge_tpu.training.train_step import TrainState as JaxTrainState
from specforge_tpu.training.train_step import (
    make_train_step as jax_make_train_step,
)
from specforge_tpu_torch.algorithms.eagle3.model import OnlineEagle3Model
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.data import vlm
from specforge_tpu_torch.data.collator import CollatorConfig, PaddingCollator
from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    LlamaEagle3Draft,
)
from specforge_tpu_torch.training import optimizer as pt_opt
from specforge_tpu_torch.training.strategies import Eagle3TrainStrategy
from specforge_tpu_torch.training.train_step import TrainState, make_train_step

B, S, V, VD, HID, LENGTH = 2, 64, 2048, 512, 128, 7
MROPE = {"rope_type": "mrope", "mrope_section": [4, 6, 6]}
CFG_KW = dict(vocab_size=V, draft_vocab_size=VD, hidden_size=HID,
              intermediate_size=3 * HID, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=4096,
              rope_scaling=MROPE)
STEP_RTOL = 1e-5  # tests/test_train_step.py:115-123
IMAGE = 7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per worker: several pytest workers share
    the machine in the tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


SPAN_CASES = [
    ("text", 16, []),
    ("image", 24, [(4, 1, 2, 3)]),
    ("video_and_image", 64, [(2, 2, 2, 3), (40, 1, 3, 4)]),
    ("span_at_end", 20, [(8, 1, 3, 4)]),
]


@pytest.mark.parametrize("seq_len,spans", [c[1:] for c in SPAN_CASES],
                         ids=[c[0] for c in SPAN_CASES])
def test_mrope_position_ids_and_spans_match_jax(seq_len, spans):
    ids = np.arange(seq_len) % 5 + 10
    for start, tt, h, w in spans:
        ids[start:start + tt * h * w] = IMAGE
    grids = [(tt, h, w) for _, tt, h, w in spans]
    got_spans = vlm.spans_from_token_ids(ids, IMAGE, grids)
    ref_spans = jax_vlm.spans_from_token_ids(ids, IMAGE, grids)
    assert [vars(s) for s in got_spans] == [vars(s) for s in ref_spans]
    assert [(s.start, s.t, s.h, s.w) for s in got_spans] == spans
    got = vlm.mrope_position_ids(seq_len, got_spans)
    ref = jax_vlm.mrope_position_ids(seq_len, ref_spans)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_vlm_errors_match_jax():
    for mod in (vlm, jax_vlm):
        with pytest.raises(ValueError, match="exceeds"):
            mod.mrope_position_ids(8, [mod.VisionSpan(start=4, t=1, h=2, w=3)])
        with pytest.raises(ValueError, match="overlapping"):
            mod.mrope_position_ids(32, [mod.VisionSpan(0, 1, 2, 2),
                                        mod.VisionSpan(2, 1, 2, 2)])
        with pytest.raises(ValueError, match="more image-token runs"):
            mod.spans_from_token_ids([IMAGE, 1, IMAGE], IMAGE, [(1, 1, 1)])
        with pytest.raises(ValueError, match="grid"):
            mod.spans_from_token_ids([IMAGE, IMAGE, 1], IMAGE, [(1, 1, 1)])


@pytest.mark.parametrize("lengths", [(5, 9), (12, 3)])
def test_collator_pads_3d_position_ids_like_jax(lengths):
    """[3, S] ids padded with 0 (or cut) on the sequence axis, stacked
    batch-first [B, 3, L], beside [S] ids of the same length."""
    L = 8
    rng = np.random.default_rng(3)
    samples = []
    for n in lengths:
        spans = [jax_vlm.VisionSpan(1, 1, 1, 2)] if n > 4 else []
        samples.append({
            "input_ids": rng.integers(0, V, size=(n,)).astype(np.int64),
            "loss_mask": np.ones(n, np.int64),
            "position_ids": jax_vlm.mrope_position_ids(n, spans) + 1,
        })
    ref = JaxPaddingCollator(JaxCollatorConfig(max_length=L))(samples)
    got = PaddingCollator(CollatorConfig(max_length=L))(
        [{k: t(v) for k, v in s.items()} for s in samples])
    assert sorted(got.tensors) == sorted(ref.tensors)
    for key, value in ref.tensors.items():
        assert got.tensors[key].dtype == getattr(torch, str(value.dtype)), key
        np.testing.assert_array_equal(got.tensors[key].numpy(), value,
                                      err_msg=key)
    assert tuple(got.tensors["position_ids"].shape) == (2, 3, L)
    with pytest.raises(ValueError, match=r"\[S\] or \[3, S\]"):
        PaddingCollator(CollatorConfig(max_length=L))(
            [{"input_ids": t(np.zeros(4, np.int64)),
              "position_ids": t(np.zeros((2, 4), np.int64))}])


@pytest.fixture(scope="module")
def mrope_setup():
    rng = np.random.default_rng(0)
    keep = np.sort(rng.choice(V, size=VD, replace=False))
    t2d = np.zeros(V, bool)
    t2d[keep] = True
    d2t = (keep - np.arange(VD)).astype(np.int32)
    jax_model = JaxOnlineEagle3Model(
        draft_model=JaxDraft(JaxEagle3Config(**CFG_KW), dtype=jnp.float32),
        length=LENGTH,
    )
    attention_mask = np.ones((B, S), np.int32)
    attention_mask[1, 50:] = 0
    vision = jax_vlm.mrope_position_ids(
        S, [jax_vlm.VisionSpan(start=6, t=2, h=3, w=4)])
    batch = dict(
        input_ids=rng.integers(0, V, size=(B, S)).astype(np.int32),
        attention_mask=attention_mask,
        loss_mask=(rng.random((B, S)) > 0.2).astype(np.int32),
        hidden_state=rng.normal(size=(B, S, 3 * HID)).astype(np.float32),
        target=rng.normal(size=(B, S, HID)).astype(np.float32),
        position_ids=np.stack([vision, jax_vlm.mrope_position_ids(S)]),
    )
    variables = jax_model.init(
        jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]),
        jnp.asarray(attention_mask),
        jnp.asarray(batch["loss_mask"][..., None]),
        jnp.asarray(batch["hidden_state"]), jnp.zeros((B, S, V), jnp.float32),
    )
    variables = {
        "params": variables["params"],
        "buffers": {"draft_model": {"t2d": jnp.asarray(t2d),
                                    "d2t": jnp.asarray(d2t)}},
    }
    head = (rng.normal(size=(V, HID)) * 0.2).astype(np.float32)
    return jax_model, variables, batch, head


def port_model(variables, backend="pallas"):
    draft = LlamaEagle3Draft(Eagle3Config(**CFG_KW), dtype=torch.float32,
                             attention_backend=backend, device="cpu")
    model = OnlineEagle3Model(draft, length=LENGTH)
    model.load_state_dict(params_from_jax(jax.device_get(variables)))
    return model


def test_mrope_train_step_matches_jax(mrope_setup):
    """One AdamW step on a batch whose first row holds a video span: the
    loss, metrics, grad norm and every updated parameter (so the
    gradients); the 3-D ids reach all 7 TTT steps with the branch offset
    on every axis."""
    jax_model, variables, batch, head = mrope_setup
    metadata = {"target_repr": "hidden_state"}
    opt_kw = dict(lr=1e-3, warmup_ratio=0.0, adam_eps=1e-3)
    total = 10
    initial = jax.device_get(variables)
    mask = jax_opt.embedding_freeze_mask(variables["params"])
    tx = jax_opt.build_optimizer(jax_opt.OptimizerConfig(**opt_kw), total)
    jstate = JaxTrainState.create(variables["params"], variables["buffers"],
                                  tx, trainable_mask=mask)
    jstep = jax_make_train_step(
        JaxEagle3TrainStrategy(jax_model, compact_teacher=True), tx,
        accum_steps=1, total_steps=total, metadata=metadata,
        trainable_mask=mask,
        lr_schedule=jax_opt.build_lr_schedule(
            jax_opt.OptimizerConfig(**opt_kw), total),
    )
    jstate, jmetrics = jstep(
        jstate, {k: jnp.asarray(v)[None] for k, v in batch.items()},
        {"target_head_weight": jnp.asarray(head)})

    model = port_model(initial)
    strategy = Eagle3TrainStrategy(model, compact_teacher=True)
    opt = pt_opt.build_optimizer(pt_opt.OptimizerConfig(**opt_kw), total)
    state = TrainState.create(model, opt, pt_opt.embedding_freeze_mask(model))
    step = make_train_step(
        strategy, opt, accum_steps=1, total_steps=total, metadata=metadata,
        lr_schedule=pt_opt.build_lr_schedule(pt_opt.OptimizerConfig(**opt_kw),
                                             total),
    )
    state, metrics = step(state, {k: t(v)[None] for k, v in batch.items()},
                          {"target_head_weight": t(head)})
    for key in ("train/loss", "train/grad_norm", "train/acc_0",
                "train/ploss_6", "train/acceptance_rate_3"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=STEP_RTOL, err_msg=key)
    updated = params_from_jax(jax.device_get(
        {"params": jstate.params, "buffers": initial["buffers"]}))
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), updated[name].numpy(),
                                   rtol=STEP_RTOL, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_mrope_eval_sums_match_jax(mrope_setup, backend):
    """The eval pass's sums on the same batch; and text-only [B, 3, S] ids
    give the implicit-arange result, as in the JAX test."""
    jax_model, variables, batch, head = mrope_setup
    meta = {"target_repr": "hidden_state"}
    frozen_j = {"target_head_weight": jnp.asarray(head)}
    ref = JaxEagle3TrainStrategy(jax_model).eval_outputs(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}, frozen_j,
        meta)
    strategy = Eagle3TrainStrategy(port_model(variables, backend))
    frozen = {"target_head_weight": t(head)}
    with torch.no_grad():
        out = strategy.eval_outputs({k: t(v) for k, v in batch.items()},
                                    frozen, meta)
        text = dict(batch, position_ids=np.broadcast_to(
            np.arange(S, dtype=np.int32), (B, 3, S)))
        text_out = strategy.eval_outputs({k: t(v) for k, v in text.items()},
                                         frozen, meta)
        implicit = {k: v for k, v in batch.items() if k != "position_ids"}
        implicit_out = strategy.eval_outputs(
            {k: t(v) for k, v in implicit.items()}, frozen, meta)
    assert sorted(out) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(out[key].numpy(), np.asarray(value),
                                   rtol=STEP_RTOL, atol=1e-4, err_msg=key)
    for key in out:
        torch.testing.assert_close(text_out[key], implicit_out[key], rtol=0,
                                   atol=0)
    assert not torch.equal(out["loss_sums"], implicit_out["loss_sums"])
