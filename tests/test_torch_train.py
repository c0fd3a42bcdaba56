"""The PyTorch port's training path against the JAX package, on the CPU.

Small size (hidden 128, 4 heads, 2 kv heads, S 64, vocab 2048, draft vocab
512) in fp32, with numpy inputs from a seed handed to both sides. Weights
cross over through ``params_from_jax``. The port's draft runs the
``"pallas"`` backend, whose autograd Functions take their plain versions on
CPU tensors. Each tolerance is taken from the matching JAX test."""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from specforge_tpu.algorithms.eagle3.model import (
    OnlineEagle3Model as JaxOnlineEagle3Model,
)
from specforge_tpu.application.composition import (
    build_training_run as jax_build_training_run,
)
from specforge_tpu.config.schema import Config as JaxConfig
from specforge_tpu.config.schema import load_config as jax_load_config
from specforge_tpu.models.draft.llama_eagle3 import (
    Eagle3Config as JaxEagle3Config,
)
from specforge_tpu.models.draft.llama_eagle3 import LlamaEagle3Draft as JaxDraft
from specforge_tpu.models.target.head import TargetHead as JaxTargetHead
from specforge_tpu.runtime.data_plane.feature_file import (
    save_feature_file as jax_save_feature_file,
)
from specforge_tpu.training import optimizer as jax_opt
from specforge_tpu.training import schedule as jax_schedule
from specforge_tpu.training.strategies import (
    Eagle3TrainStrategy as JaxEagle3TrainStrategy,
)
from specforge_tpu.training.train_step import TrainState as JaxTrainState
from specforge_tpu.training.train_step import (
    make_train_step as jax_make_train_step,
)
from specforge_tpu.training.vocab_mapping import (
    derive_from_offline_dir as jax_derive_from_offline_dir,
)
from specforge_tpu_torch import cli
from specforge_tpu_torch.algorithms.eagle3.model import OnlineEagle3Model
from specforge_tpu_torch.application.composition import build_training_run
from specforge_tpu_torch.config.schema import ConfigError, load_config
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    LlamaEagle3Draft,
)
from specforge_tpu_torch.models.target.head import TargetHead
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    save_feature_file,
)
from specforge_tpu_torch.training import optimizer as pt_opt
from specforge_tpu_torch.training import schedule as pt_schedule
from specforge_tpu_torch.training.strategies import Eagle3TrainStrategy
from specforge_tpu_torch.training.train_step import TrainState, make_train_step
from specforge_tpu_torch.training.vocab_mapping import derive_from_offline_dir

B, S, V, VD, HID, LENGTH = 2, 64, 2048, 512, 128, 7
CFG_KW = dict(vocab_size=V, draft_vocab_size=VD, hidden_size=HID,
              intermediate_size=3 * HID, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=4096)
REPO = os.path.join(os.path.dirname(__file__), "..")
STEP_RTOL = 1e-5   # tests/test_train_step.py:115-123
CURVE_RTOL = 1e-4  # tests/test_train_step.py:123
OPT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this module's small CPU shapes: the
    tier-1 run puts several pytest workers on one machine, and torch's
    default of a thread per core then oversubscribes the CPU; the port's
    many small ops wait on descheduled threads at every op (under six busy
    single-threaded processes two trainer tests took 53 s with eight
    threads and 10 s with one). One thread is not slower on an idle
    machine at these shapes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


# --------------------------------------------------------------------------
# optimizer and schedule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("moments_dtype,scheduler", [
    ("float32", "cosine"), ("bfloat16", "cosine"), ("float32", "constant"),
])
def test_optimizer_matches_optax(moments_dtype, scheduler):
    """Clip, warmup-cosine (or constant) AdamW over 5 steps on fixed grads;
    the clip triggers on some steps and not on others."""
    rng = np.random.default_rng(0)
    shapes = {"a": (16, 8), "b": (32,), "c": (4, 4, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()}
             for scale in (1.0, 0.01, 3.0, 0.02, 1.0)]
    kw = dict(lr=1e-2, warmup_ratio=0.2, weight_decay=0.01, max_grad_norm=0.5,
              lr_scheduler=scheduler, moments_dtype=moments_dtype)
    total = 10
    tx = jax_opt.build_optimizer(jax_opt.OptimizerConfig(**kw), total)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    opt = pt_opt.build_optimizer(pt_opt.OptimizerConfig(**kw), total)
    tp = {k: t(v) for k, v in params.items()}
    ts = opt.init(tp)
    j_sched = jax_opt.build_lr_schedule(jax_opt.OptimizerConfig(**kw), total)
    for step, g in enumerate(grads):
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = opt.step(tp, {k: t(v) for k, v in g.items()}, ts)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=OPT_RTOL, atol=1e-7,
                                       err_msg=f"step {step} param {k}")
        assert opt.schedule(step) == pytest.approx(float(j_sched(step)),
                                                   rel=1e-7)
    assert ts["count"] == len(grads)
    assert ts["mu"]["a"].dtype == getattr(torch, moments_dtype)


def test_clip_has_no_epsilon_and_only_clips_above_the_norm():
    g = {"x": torch.tensor([3.0, 4.0])}
    torch.testing.assert_close(pt_opt.clip_by_global_norm(g, 10.0)["x"],
                               g["x"])
    torch.testing.assert_close(pt_opt.clip_by_global_norm(g, 1.0)["x"],
                               torch.tensor([0.6, 0.8]))


def test_unported_optimizer_options_raise():
    for kw in ({"factored_second_moments": True},
               {"row_sparse_embedding": True}):
        with pytest.raises(NotImplementedError, match="P-EAGLE"):
            pt_opt.build_optimizer(pt_opt.OptimizerConfig(**kw), 10)


@pytest.mark.parametrize("samples,batch,accum,epochs", [
    (16, 2, 2, 1), (17, 2, 3, 2), (8, 4, 1, 3),
])
def test_schedule_matches_jax(samples, batch, accum, epochs):
    assert pt_schedule.steps_per_epoch(samples, batch, accum) == (
        jax_schedule.steps_per_epoch(samples, batch, accum))
    assert pt_schedule.resolve_total_steps(samples, batch, accum, epochs) == (
        jax_schedule.resolve_total_steps(samples, batch, accum, epochs))
    with pytest.raises(ValueError):
        pt_schedule.validate_fixed_accumulation_plan(1, 2, 1)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _vocab_maps(rng):
    keep = np.sort(rng.choice(V, size=VD, replace=False))
    t2d = np.zeros(V, bool)
    t2d[keep] = True
    return t2d, (keep - np.arange(VD)).astype(np.int32)


@pytest.fixture(scope="module")
def step_setup():
    rng = np.random.default_rng(0)
    t2d, d2t = _vocab_maps(rng)
    jax_model = JaxOnlineEagle3Model(
        draft_model=JaxDraft(JaxEagle3Config(**CFG_KW), dtype=jnp.float32),
        length=LENGTH,
    )
    accum = 2
    attention_mask = np.ones((accum, B, S), np.int32)
    attention_mask[:, 1, 50:] = 0
    batch = dict(
        input_ids=rng.integers(0, V, size=(accum, B, S)).astype(np.int32),
        attention_mask=attention_mask,
        loss_mask=(rng.random((accum, B, S)) > 0.2).astype(np.int32),
        hidden_state=rng.normal(size=(accum, B, S, 3 * HID)).astype(
            np.float32),
        target=rng.normal(size=(accum, B, S, HID)).astype(np.float32),
    )
    variables = jax_model.init(
        jax.random.PRNGKey(0),
        jnp.asarray(batch["input_ids"][0]),
        jnp.asarray(batch["attention_mask"][0]),
        jnp.asarray(batch["loss_mask"][0][..., None]),
        jnp.asarray(batch["hidden_state"][0]),
        jnp.zeros((B, S, V), jnp.float32),
    )
    variables = {
        "params": variables["params"],
        "buffers": {"draft_model": {"t2d": jnp.asarray(t2d),
                                    "d2t": jnp.asarray(d2t)}},
    }
    head = (rng.normal(size=(V, HID)) * 0.2).astype(np.float32)
    return jax_model, variables, batch, head


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(step_setup, accum):
    """One optimizer step of the compact-teacher EAGLE3 strategy: the loss,
    grad_norm and every updated parameter; the frozen embedding stays."""
    jax_model, variables, batch, head = step_setup
    batch = {k: v[:accum] for k, v in batch.items()}
    metadata = {"target_repr": "hidden_state"}
    # Adam's first step is g / (|g| + eps): with the default eps of 1e-8 an
    # element whose gradient is itself near 1e-8 (a sum that cancels, so its
    # last digits depend on the order of the sum) moves by up to lr/2 on
    # either side. A larger eps keeps every element's update a smooth
    # function of its gradient, so the parameters can be held at rtol 1e-5.
    opt_kw = dict(lr=1e-3, warmup_ratio=0.0, adam_eps=1e-3)
    total = 10

    initial = jax.device_get(variables)  # the JAX step donates its state
    jax_strategy = JaxEagle3TrainStrategy(jax_model, compact_teacher=True,
                                          compact_teacher_chunk_size=700)
    mask = jax_opt.embedding_freeze_mask(variables["params"])
    tx = jax_opt.build_optimizer(jax_opt.OptimizerConfig(**opt_kw), total)
    jstate = JaxTrainState.create(variables["params"], variables["buffers"],
                                  tx, trainable_mask=mask)
    jstep = jax_make_train_step(
        jax_strategy, tx, accum_steps=accum, total_steps=total,
        metadata=metadata, trainable_mask=mask,
        lr_schedule=jax_opt.build_lr_schedule(
            jax_opt.OptimizerConfig(**opt_kw), total),
    )
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                             {"target_head_weight": jnp.asarray(head)})

    draft = LlamaEagle3Draft(Eagle3Config(**CFG_KW), dtype=torch.float32,
                             attention_backend="pallas", device="cpu")
    model = OnlineEagle3Model(draft, length=LENGTH)
    model.load_state_dict(params_from_jax(initial))
    strategy = Eagle3TrainStrategy(model, compact_teacher=True,
                                   compact_teacher_chunk_size=700)
    pmask = pt_opt.embedding_freeze_mask(model)
    opt = pt_opt.build_optimizer(pt_opt.OptimizerConfig(**opt_kw), total)
    state = TrainState.create(model, opt, pmask)
    assert "draft_model.embed_tokens.weight" not in state.params
    embed_before = model.draft_model.embed_tokens.weight.detach().clone()
    step = make_train_step(
        strategy, opt, accum_steps=accum, total_steps=total,
        metadata=metadata,
        lr_schedule=pt_opt.build_lr_schedule(pt_opt.OptimizerConfig(**opt_kw),
                                             total),
    )
    state, metrics = step(state, {k: t(v) for k, v in batch.items()},
                          {"target_head_weight": t(head)})

    assert state.step == 1
    for key in ("train/loss", "train/grad_norm", "train/lr", "train/acc_0",
                "train/ploss_6", "train/acceptance_rate_0"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=STEP_RTOL, err_msg=key)
    updated = params_from_jax(jax.device_get(
        {"params": jstate.params, "buffers": initial["buffers"]}))
    for name, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), updated[name].numpy(),
                                   rtol=STEP_RTOL, atol=1e-7, err_msg=name)
    torch.testing.assert_close(model.draft_model.embed_tokens.weight,
                               embed_before, rtol=0, atol=0)


def test_compute_params_dtype_casts_once_and_trains(step_setup):
    """compute_params_dtype='bfloat16': the draft's Linear layers see bf16
    weights (no per-call cast), and the step still trains the fp32 masters."""
    _, variables, batch, head = step_setup
    batch = {k: v[:1] for k, v in batch.items()}
    draft = LlamaEagle3Draft(Eagle3Config(**CFG_KW), dtype=torch.bfloat16,
                             attention_backend="pallas", device="cpu")
    model = OnlineEagle3Model(draft, length=3)
    model.load_state_dict(params_from_jax(jax.device_get(variables)))
    strategy = Eagle3TrainStrategy(model, compact_teacher=True)
    opt = pt_opt.build_optimizer(pt_opt.OptimizerConfig(lr=1e-3), 10)
    state = TrainState.create(model, opt, pt_opt.embedding_freeze_mask(model))
    seen = []
    hook = model.draft_model.lm_head.register_forward_pre_hook(
        lambda mod, args: seen.append(mod.weight.dtype))
    step = make_train_step(strategy, opt, accum_steps=1,
                           metadata={"target_repr": "hidden_state"},
                           compute_params_dtype="bfloat16")
    before = model.draft_model.lm_head.weight.detach().clone()
    state, metrics = step(state, {k: t(v) for k, v in batch.items()},
                          {"target_head_weight": t(head)})
    hook.remove()
    assert seen and all(d == torch.bfloat16 for d in seen)
    assert model.draft_model.lm_head.weight.dtype == torch.float32
    assert not torch.equal(model.draft_model.lm_head.weight, before)
    assert np.isfinite(float(metrics["train/loss"]))


# --------------------------------------------------------------------------
# the whole run, across frameworks and on its own
# --------------------------------------------------------------------------

TINY_DRAFT = dict(CFG_KW, architectures=["LlamaForCausalLMEagle3"],
                  num_hidden_layers=1)


def write_features(root, n, seed, port_writer):
    """Offline feature files (the layout of tests/_fixtures.py)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        seq = int(rng.integers(40, S + 1))
        arrays = {
            "input_ids": rng.integers(0, V, size=(seq,)).astype(np.int64),
            "loss_mask": (rng.random(seq) > 0.25).astype(np.int64),
            "hidden_state": rng.normal(size=(seq, 3 * HID)).astype(
                ml_dtypes.bfloat16),
            "target": rng.normal(size=(seq, HID)).astype(ml_dtypes.bfloat16),
        }
        path = os.path.join(root, f"sample-{i:04d}.sft")
        meta = {"target_repr": "hidden_state"}
        if port_writer:
            save_feature_file(path, {
                k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v)
                for k, v in arrays.items()}, meta)
        else:
            jax_save_feature_file(path, arrays, meta)


def run_config(tmp_path, run_id, ttt_length=3, **training):
    data = tmp_path / "data"
    if not data.exists():
        write_features(str(data), 8, seed=0, port_writer=True)
    return {
        "run_id": run_id,
        "output_dir": str(tmp_path / "runs"),
        "model": {"draft_config": TINY_DRAFT, "compute_dtype": "float32"},
        "data": {"train_data_path": str(data), "max_length": S,
                 "num_workers": 0},
        "training": {"strategy": "eagle3", "batch_size": 2,
                     "num_epochs": 2, "log_interval": 1,
                     "ttt_length": ttt_length, "attention_backend": "pallas",
                     "compact_teacher": True, "learning_rate": 1e-3,
                     "max_checkpoints": 10, **training},
        "tracking": {"backend": "jsonl"},
    }


def frozen_tables(seed=1):
    rng = np.random.default_rng(seed)
    return {
        "target_head_weight": (rng.normal(size=(V, HID)) * 0.2).astype(
            np.float32),
        "target_embed_weight": rng.normal(size=(V, HID)).astype(np.float32),
    }


def port_trainer(tmp_path, run_id, **training):
    config = load_config_dict(tmp_path, run_config(tmp_path, run_id,
                                                   **training))
    return build_training_run(config, frozen_override=frozen_tables(),
                              device="cpu")


def load_config_dict(tmp_path, raw):
    path = tmp_path / f"{raw['run_id']}.json"
    path.write_text(json.dumps(raw))
    return load_config(str(path))


def metric_records(out_dir, run_id):
    lines = (out_dir / f"{run_id}.metrics.jsonl").read_text()
    return [json.loads(line) for line in lines.splitlines()]


def test_loss_curve_matches_jax_trainer(tmp_path):
    """JAX build_training_run(frozen_override) and the port's, on the same
    feature files, from the same initial weights: 3 optimizer steps of 2
    micro-batches; train/loss and train/grad_norm at every step."""
    # 12 files written by the JAX package: 3 steps of 2 micro-batches of 2
    write_features(str(tmp_path / "data"), 12, seed=0, port_writer=False)
    raw = run_config(tmp_path, "curve", num_epochs=1, accumulation_steps=2,
                     warmup_ratio=0.5)
    # the JAX side runs its dense attention (its Pallas kernels run on the
    # CPU only in interpret mode, which its trainer does not ask for)
    jax_raw = json.loads(json.dumps(raw))
    jax_raw["output_dir"] = str(tmp_path / "jax")
    jax_raw["training"]["attention_backend"] = "dense"
    jax_trainer = jax_build_training_run(
        JaxConfig.model_validate(jax_raw),
        frozen_override={k: jnp.asarray(v) for k, v in frozen_tables().items()},
    )
    trainer = build_training_run(load_config_dict(tmp_path, raw),
                                 frozen_override=frozen_tables(), device="cpu")
    trainer.strategy.model.load_state_dict(params_from_jax(jax.device_get({
        "params": jax_trainer.state.params,
        "buffers": jax_trainer.state.buffers,
    })))
    jax_trainer.fit()
    trainer.fit()
    assert trainer.state.step == 3
    jax_steps = [r for r in metric_records(tmp_path / "jax", "curve")
                 if "train/loss" in r]
    steps = [r for r in metric_records(tmp_path / "runs", "curve")
             if "train/loss" in r]
    assert [r["step"] for r in steps] == [r["step"] for r in jax_steps] == [
        1, 2, 3]
    for mine, ref in zip(steps, jax_steps):
        for key in ("train/loss", "train/grad_norm", "train/lr"):
            np.testing.assert_allclose(mine[key], ref[key], rtol=CURVE_RTOL,
                                       err_msg=f"step {ref['step']} {key}")


def test_fit_checkpoints_and_eval(tmp_path):
    raw = run_config(tmp_path, "t0")
    raw["data"]["eval_data_path"] = raw["data"]["train_data_path"]
    trainer = build_training_run(load_config_dict(tmp_path, raw),
                                 frozen_override=frozen_tables(), device="cpu")
    metrics = trainer.fit()
    assert trainer.state.step == 8  # 8 samples / batch 2 × 2 epochs
    assert 0.0 <= metrics["eval/simulated_acc_len"] <= 3
    runs = tmp_path / "runs"
    assert (runs / "t0-step8" / "contract.json").exists()
    assert (runs / "t0-step8" / "state" / "state.pt").exists()
    assert (runs / "t0.latest").read_text() == "8"
    assert (runs / "t0.vocab_mapping.npz").exists()
    assert int(trainer.strategy.model.draft_model.t2d.sum()) == VD
    records = metric_records(runs, "t0")
    assert any("perf/steps_per_hour" in r for r in records)
    assert any("eval/acc_0" in r for r in records)
    # the target embedding was copied in, frozen and cast to bf16
    embed = trainer.strategy.model.draft_model.embed_tokens.weight
    assert embed.dtype == torch.bfloat16 and not embed.requires_grad
    np.testing.assert_array_equal(
        embed.float().numpy(),
        frozen_tables()["target_embed_weight"].astype(ml_dtypes.bfloat16)
        .astype(np.float32))


def test_resume_mid_run_reaches_the_same_weights(tmp_path):
    full = port_trainer(tmp_path, "full")
    full.fit()
    interrupted = port_trainer(tmp_path, "int", save_interval=2)
    interrupted.fit()
    (tmp_path / "runs" / "int.latest").write_text("6")  # a crash after 6
    resumed = port_trainer(tmp_path, "int", resume=True)
    resumed.fit()
    assert resumed.state.step == 8
    for name, p in full.state.params.items():
        torch.testing.assert_close(resumed.state.params[name], p, rtol=0,
                                   atol=0, msg=name)
    # an explicit step dir of another run, under a new run id
    other = port_trainer(tmp_path, "dst",
                         resume_from=str(tmp_path / "runs" / "int-step4"))
    other.fit()
    assert other.state.step == 8
    for name, p in full.state.params.items():
        torch.testing.assert_close(other.state.params[name], p, rtol=0,
                                   atol=0, msg=name)


def test_resume_contract_mismatch_refuses(tmp_path):
    port_trainer(tmp_path, "c0", num_epochs=1).fit()
    mismatched = port_trainer(tmp_path, "c0", num_epochs=1, resume=True,
                              accumulation_steps=2)
    with pytest.raises(ValueError, match="resume contract mismatch"):
        mismatched.fit()


def test_cli_train_and_plan(tmp_path, capsys):
    raw = run_config(tmp_path, "cli0", num_epochs=1)
    raw["model"]["target_model_path"] = str(write_target_dir(tmp_path))
    path = tmp_path / "run.json"
    path.write_text(json.dumps(raw))
    assert cli.main(["train", "-c", str(path), "--plan",
                     "--set", "training.seed=7"]) == 0
    plan = json.loads(capsys.readouterr().out)
    assert plan["training"]["seed"] == 7
    assert cli.main(["train", "-c", str(path), "--device", "cpu"]) == 0
    assert (tmp_path / "runs" / "cli0-step4" / "state" / "state.pt").exists()
    with pytest.raises(ConfigError, match="unknown key"):
        cli.main(["train", "-c", str(path), "--set", "training.bogus=1"])


def test_default_device_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = load_config_dict(tmp_path, run_config(tmp_path, "nocuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_training_run(config, frozen_override=frozen_tables())


@pytest.mark.parametrize("override,slice_name", [
    ("training.strategy=\"dflash\"", "DFlash"),
    ("training.strategy=\"peagle\"", "P-EAGLE"),
    ("training.fsdp_size=2", "parallelism"),
    ("data.pack_documents=true", "P-EAGLE"),
    ("tracking.backend=\"wandb\"", "ROADMAP"),
])
def test_unported_options_name_their_slice(tmp_path, override, slice_name):
    path = tmp_path / "run.json"
    path.write_text(json.dumps(run_config(tmp_path, "unported")))
    with pytest.raises(NotImplementedError, match=slice_name):
        build_training_run(load_config(str(path), [override]),
                           frozen_override=frozen_tables(), device="cpu")


# --------------------------------------------------------------------------
# config, target head, vocab mapping
# --------------------------------------------------------------------------

EXAMPLES = sorted(
    os.path.join(REPO, "examples", n)
    for n in os.listdir(os.path.join(REPO, "examples")) if n.endswith(".json")
)


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_examples_load_to_the_same_fields_as_jax(path):
    assert load_config(path).model_dump() == jax_load_config(path).model_dump()
    overrides = ["training.accumulation_steps=2", "training.learning_rate=1",
                 "data.eval_data_path=null"]
    assert load_config(path, overrides).model_dump() == jax_load_config(
        path, overrides).model_dump()
    for bad in (["training.bogus=1"], ["nosection.x=1"],
                ["training.batch_size=0"], ["training.lr_scheduler=\"x\""]):
        with pytest.raises(ValueError):
            jax_load_config(path, bad)
        with pytest.raises(ValueError):
            load_config(path, bad)


def test_cross_field_checks_match_jax():
    for raw in (
        {"training": {"attention_backend": "usp", "batch_size": 2,
                      "sp_ring_size": 2}},
        {"training": {"sp_ring_size": 2}},
        {"deployment": {"server_urls": ["http://x:9000"]}},
        {"deployment": {"mode": "disaggregated",
                        "server_urls": ["http://x"]}},
        {"model": {"draft_config_path": "a", "draft_config": {"x": 1}}},
        {"runtime": {"store_backend": "shared_dir"}},
    ):
        with pytest.raises(ValueError):
            JaxConfig.model_validate(raw)
        with pytest.raises(ValueError):
            load_config_from(raw)


def load_config_from(raw):
    from specforge_tpu_torch.config.schema import Config

    return Config.model_validate(raw)


def write_target_dir(tmp_path, tied=False):
    """A fake HF target dir: config.json, an index and one shard written by
    the port's safetensors writer."""
    root = tmp_path / ("target-tied" if tied else "target")
    root.mkdir(exist_ok=True)
    tables = frozen_tables()
    tensors = {"model.embed_tokens.weight": t(tables["target_embed_weight"])
               .to(torch.bfloat16)}
    if not tied:
        tensors["lm_head.weight"] = t(tables["target_head_weight"]).to(
            torch.bfloat16)
    save_feature_file(str(root / "model-00001-of-00001.safetensors"), tensors)
    (root / "config.json").write_text(json.dumps(
        {"tie_word_embeddings": tied, "vocab_size": V, "hidden_size": HID}))
    (root / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: "model-00001-of-00001.safetensors"
                        for k in tensors}}))
    return root


@pytest.mark.parametrize("tied", [False, True])
def test_target_head_from_pretrained_matches_jax(tmp_path, tied):
    root = str(write_target_dir(tmp_path, tied))
    for key in ("lm_head.weight", "model.embed_tokens.weight"):
        got = TargetHead.from_pretrained(root, lm_head_key=key).weight
        ref = JaxTargetHead.from_pretrained(root, lm_head_key=key).weight
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))


def test_vocab_mapping_derivation_matches_jax(tmp_path):
    root = str(tmp_path / "feats")
    write_features(root, 6, seed=3, port_writer=True)
    t2d, d2t = derive_from_offline_dir(root, V, VD)
    t2d_j, d2t_j = jax_derive_from_offline_dir(root, V, VD)
    np.testing.assert_array_equal(t2d, t2d_j)
    np.testing.assert_array_equal(d2t, d2t_j)
    assert t2d.sum() == VD
