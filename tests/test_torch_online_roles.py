"""The port's online roles on the CPU: ``run_producer`` then
``run_consumer`` against the store server the port builds and the port's
capture server (``tests/test_launch_and_roles.py:164``); the online losses
against the port's offline trainer over the same features in the same
order (rtol 1e-6); the port's online run against the JAX package's online
run over the same capture server and prompts (``CURVE_RTOL``); the launch
plan against JAX's, command for command; the supervisor; a producer's
restart."""

import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu_torch.application import composition
from specforge_tpu_torch.application.disaggregated import (
    run_consumer,
    run_producer,
)
from specforge_tpu_torch.config.schema import Config
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.inference.capture_server import (
    CaptureEngine,
    CaptureServer,
)
from specforge_tpu_torch.inference.server_capture_adapter import (
    HTTPCaptureAdapter,
)
from specforge_tpu_torch.launch_plan import (
    LaunchPlan,
    PlannedCommand,
    Readiness,
    build_launch_plan,
    run_commands,
)
from specforge_tpu_torch.models.target import transformer as pt_tf
from specforge_tpu_torch.runtime.control_plane.metadata_store import (
    SQLiteMetadataStore,
)
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    save_feature_file,
)
from specforge_tpu_torch.runtime.data_plane.feature_store import (
    InMemoryFeatureStore,
)
from specforge_tpu_torch.runtime.data_plane.network_store import server_path
from specforge_tpu_torch.runtime.data_plane.streaming_ref_channel import (
    StreamingRefChannel,
)
from specforge_tpu_torch.training.vocab_mapping import (
    derive_vocab_mapping,
    save_vocab_mapping,
)
from tests._torch_online import (
    H,
    LAYERS,
    MAXLEN,
    TINY_DRAFT,
    V,
    metric_steps,
    payload,
    start_store,
    store_objects,
    write_prompts,
)
from tests.test_torch_capture import save_target

CURVE_RTOL = 1e-4  # tests/test_torch_train.py (tests/test_train_step.py:123)
N_PROMPTS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per test worker (see test_torch_train.py's
    fixture of the same name: the default oversubscribes a shared CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """The port-built store server and the port's capture server on a tiny
    llama target (fp32 weights) → (target, store endpoint, server URL)."""
    root = tmp_path_factory.mktemp("online")
    target = save_target(root / "target", "llama")
    store_proc, endpoint = start_store()
    pcfg = pt_tf.TargetConfig.from_file(target)
    server = CaptureServer(CaptureEngine(
        target, capture_layers=LAYERS, max_length=MAXLEN, target_config=pcfg,
        target_params=pt_tf.load_target_params(target, pcfg,
                                               dtype=torch.float32,
                                               device="cpu"))).start()
    try:
        yield target, endpoint, f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()
        store_proc.terminate()
        store_proc.wait(timeout=10)


def online_config(tmp_path, stack, run_id, **training):
    target, endpoint, url = stack
    prompts = tmp_path / "prompts.jsonl"
    if not prompts.exists():
        records = write_prompts(prompts, N_PROMPTS)
        save_vocab_mapping(str(tmp_path / "vocab.npz"), *derive_vocab_mapping(
            (np.asarray(r["input_ids"]) for r in records), V,
            TINY_DRAFT["draft_vocab_size"]))
    raw = payload(tmp_path, run_id, target, endpoint, url, prompts,
                  **training)
    raw["model"]["vocab_mapping_path"] = str(tmp_path / "vocab.npz")
    return raw


def frozen_tables(seed=1):
    rng = np.random.default_rng(seed)
    return {
        "target_head_weight": (rng.normal(size=(V, H)) * 0.2).astype(
            np.float32),
        "target_embed_weight": rng.normal(size=(V, H)).astype(np.float32),
    }


def inbox_order(tmp_path, run_id):
    path = (tmp_path / "runs" / run_id / "consumer_state" / "inboxes-g0"
            / "rank0.jsonl")
    return [r["sample_id"] for r in map(json.loads, open(path))
            if r.get("kind") == "ref"]


def test_roles_end_to_end_and_equal_to_offline(stack, tmp_path):
    raw = online_config(tmp_path, stack, "roles")
    config = Config.model_validate(raw)
    assert run_producer(config) == N_PROMPTS
    metrics = run_consumer(config, device="cpu")
    assert np.isfinite(metrics["train/loss"])
    # every trained sample released after its durable ack
    assert metrics["store/objects"] == 0 == store_objects(stack[1])
    assert metrics["store/fetched_bytes"] > 0
    ledger = SQLiteMetadataStore(str(tmp_path / "runs" / "roles"
                                     / "consumer_state" / "consumer.sqlite"))
    assert len(ledger.acked_ids()) == N_PROMPTS and ledger.durable_step() == 4
    ledger.close()
    online = metric_steps(tmp_path / "runs" / "roles.metrics.jsonl")
    assert [r["step"] for r in online] == [1, 2, 3, 4]
    assert all("perf/ack_s_per_step" in r for r in online)

    # the same features (the server's inline sink, the producer's batch)
    # in the inbox's order, through the offline trainer
    from specforge_tpu_torch.data.prompt_builder import (
        load_prompt_records,
        prepare_prompt_tasks,
    )

    plan = prepare_prompt_tasks(load_prompt_records(raw["data"][
        "prompt_path"]), epoch=0, prompt_seed=config.training.seed)
    memory = InMemoryFeatureStore()
    refs = HTTPCaptureAdapter(stack[2], store=memory).produce_refs_batch(plan)
    by_id = {r.sample_id: memory.fetch(r) for r in refs}
    features = tmp_path / "features"
    features.mkdir()
    for i, sid in enumerate(inbox_order(tmp_path, "roles")):
        save_feature_file(str(features / f"{i:04d}.sft"), by_id[sid],
                          {"target_repr": "hidden_state"})
    offline_raw = json.loads(json.dumps(raw))
    offline_raw["run_id"] = "offline"
    offline_raw["training"]["role"] = "all"
    offline_raw["data"]["train_data_path"] = str(features)
    trainer = composition.build_training_run(
        Config.model_validate(offline_raw), device="cpu")
    trainer.fit()
    offline = metric_steps(tmp_path / "runs" / "offline.metrics.jsonl")
    assert [r["step"] for r in offline] == [1, 2, 3, 4]
    for key in ("train/loss", "train/grad_norm", "train/acc_0"):
        np.testing.assert_allclose([r[key] for r in online],
                                   [r[key] for r in offline], rtol=1e-6,
                                   err_msg=key)


def align_jax_consumer(monkeypatch) -> dict:
    """JAX's ``run_consumer`` composes its draft apart from its own
    ``build_training_run``: a bf16 draft whatever ``model.compute_dtype``,
    and the draft's random embedding left trainable where the offline
    composition copies the target's in and freezes it in bf16
    (``ROADMAP.md`` Queue 3). The port's consumer takes the offline
    composition, so for a comparison at ``CURVE_RTOL`` the JAX consumer's
    draft is built here as JAX's offline path builds it, with JAX's own
    functions: fp32, the embedding copied and frozen. Returns where its
    initial variables land."""
    from specforge_tpu.algorithms import builtin as jbuiltin
    from specforge_tpu.application import composition as jcomp
    from specforge_tpu.training import trainer as jtrainer
    from specforge_tpu.training.optimizer import (
        cast_frozen_to,
        embedding_freeze_mask,
    )

    build = jbuiltin._eagle3_build_draft
    providers = dataclasses.replace(
        jbuiltin.EAGLE3.providers,
        build_draft=lambda cfg, dtype=None: build(cfg, jnp.float32))
    monkeypatch.setattr(jbuiltin, "EAGLE3", dataclasses.replace(
        jbuiltin.EAGLE3, providers=providers))
    init = jtrainer.Trainer.__init__
    seen = {}

    def aligned(self, strategy, *, variables, frozen=None, **kw):
        variables = jcomp._copy_target_embedding(variables, frozen)
        frozen = {k: v for k, v in frozen.items()
                  if k != "target_embed_weight"}
        mask = embedding_freeze_mask(variables["params"])
        variables = {**variables, "params": cast_frozen_to(
            variables["params"], mask, jnp.bfloat16)}
        seen["variables"] = jax.device_get(variables)
        kw["trainable_mask"] = mask
        init(self, strategy, variables=variables, frozen=frozen, **kw)

    monkeypatch.setattr(jtrainer.Trainer, "__init__", aligned)
    return seen


def test_online_matches_the_jax_online_run(stack, tmp_path, monkeypatch):
    """Both packages' producers against one capture server and store, each
    package's consumer on its own channel: the same losses and gradient
    norms at every step, from JAX's initial weights."""
    from specforge_tpu.application.disaggregated import (
        run_consumer as jax_run_consumer,
    )
    from specforge_tpu.application.disaggregated import (
        run_producer as jax_run_producer,
    )
    from specforge_tpu.config.schema import Config as JaxConfig

    seen = align_jax_consumer(monkeypatch)
    jax_raw = online_config(tmp_path, stack, "jax",
                            attention_backend="dense")
    jax_config = JaxConfig.model_validate(jax_raw)
    assert jax_run_producer(jax_config) == N_PROMPTS
    jax_run_consumer(jax_config, frozen_override={
        k: jnp.asarray(v) for k, v in frozen_tables().items()})
    assert store_objects(stack[1]) == 0

    state = params_from_jax({"params": seen["variables"]["params"],
                             "buffers": seen["variables"]["buffers"]})
    build = composition.build_training_run

    def from_jax_weights(*args, **kwargs):
        trainer = build(*args, **kwargs)
        trainer.strategy.model.load_state_dict(state)
        return trainer

    monkeypatch.setattr(composition, "build_training_run", from_jax_weights)
    config = Config.model_validate(online_config(tmp_path, stack, "port"))
    assert run_producer(config) == N_PROMPTS
    run_consumer(config, frozen_override=frozen_tables(), device="cpu")
    assert inbox_order(tmp_path, "port") == inbox_order(tmp_path, "jax")
    mine = metric_steps(tmp_path / "runs" / "port.metrics.jsonl")
    ref = metric_steps(tmp_path / "runs" / "jax.metrics.jsonl")
    assert [r["step"] for r in mine] == [r["step"] for r in ref] == [
        1, 2, 3, 4]
    for key in ("train/loss", "train/grad_norm", "train/lr"):
        np.testing.assert_allclose([r[key] for r in mine],
                                   [r[key] for r in ref], rtol=CURVE_RTOL,
                                   err_msg=key)


def test_producer_restart_skips_what_the_channel_holds(stack, tmp_path):
    config = Config.model_validate(online_config(tmp_path, stack, "restart"))
    assert run_producer(config) == N_PROMPTS
    # a second start finds every prompt published: nothing captured again
    assert run_producer(config) == 0
    refs, closed, failure = StreamingRefChannel(
        config.runtime.control_dir).poll()
    assert closed and failure is None
    assert len({r.sample_id for r in refs}) == len(refs) == N_PROMPTS
    from specforge_tpu_torch.runtime.data_plane.network_store import (
        NetworkFeatureStore,
    )

    NetworkFeatureStore(stack[1]).release_refs(refs)


def test_producer_refuses_untokenised_records(stack, tmp_path):
    raw = online_config(tmp_path, stack, "raw")
    with open(raw["data"]["prompt_path"], "a") as f:
        f.write(json.dumps({"conversations": [{"role": "user",
                                               "content": "hi"}]}) + "\n")
    with pytest.raises(ValueError, match="tokenised prompt records"):
        run_producer(Config.model_validate(raw))
    raw["data"]["prompt_path"] = None
    with pytest.raises(ValueError, match="data.prompt_path"):
        run_producer(Config.model_validate(raw))


def test_consumer_refusals(stack, tmp_path, monkeypatch):
    raw = online_config(tmp_path, stack, "refuse", role="consumer")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_consumer(Config.model_validate(raw))
    raw["training"]["total_steps"] = None
    with pytest.raises(ValueError, match="requires training.total_steps"):
        run_consumer(Config.model_validate(raw), device="cpu")
    raw["training"].update(total_steps=4, resume=True, save_interval=0)
    with pytest.raises(ValueError, match="save_interval > 0"):
        run_consumer(Config.model_validate(raw), device="cpu")


# --------------------------------------------------------------------------
# the launch plan and its supervisor
# --------------------------------------------------------------------------

def plan_config(pkg, **extra):
    raw = {"run_id": "launch0", "model": {"draft_config": TINY_DRAFT},
           "training": {"role": "auto"},
           "deployment": {"mode": "disaggregated",
                          "server_urls": ["http://127.0.0.1:38201",
                                          "http://127.0.0.1:38202"]},
           "runtime": {"store_backend": "network",
                       "store_endpoint": "127.0.0.1:38150",
                       "store_secret": "hunter2"}}
    for key, value in extra.items():
        raw[key] = {**raw.get(key, {}), **value}
    if pkg == "jax":
        from specforge_tpu.config.schema import Config as JaxConfig

        return JaxConfig.model_validate(raw)
    return Config.model_validate(raw)


def commands(plan, substitute=False):
    out = []
    for c in plan.commands:
        argv = list(c.argv)
        if substitute:
            argv = [a.replace("specforge_tpu.", "specforge_tpu_torch.")
                    for a in argv]
        ready = c.readiness and (c.readiness.kind, c.readiness.target,
                                 c.readiness.timeout_s)
        out.append((c.name, argv, dict(c.env), ready, c.expected_to_exit))
    return out


@pytest.mark.parametrize("managed,extra", [
    (False, {}),
    (True, {}),
    (True, {"deployment": {"managed_local": {
        "capture_layers": [1, 2, 3], "capture_max_length": 512,
        "store_max_bytes": 1 << 30, "capture_moe_impl": "dense"}}}),
    (True, {"deployment": {"managed_local": {
        "capture_shard_devices": 0, "capture_moe_impl": "ep",
        "capture_moe_capacity_factor": 1.5}}}),
], ids=["supervisor", "managed", "managed-options", "managed-ep"])
def test_launch_plan_matches_jax(managed, extra):
    from specforge_tpu.launch_plan import (
        build_launch_plan as jax_build_launch_plan,
    )

    jax_plan = jax_build_launch_plan(plan_config("jax", **extra), "cfg.json",
                                     managed_local=managed,
                                     store_binary="bin/store")
    plan = build_launch_plan(plan_config("torch", **extra), "cfg.json",
                             managed_local=managed, store_binary="bin/store")
    assert plan.kind == jax_plan.kind
    assert commands(plan) == commands(jax_plan, substitute=True)
    rendered = plan.render()
    assert "hunter2" not in rendered and "specforge_tpu." not in rendered
    assert json.loads(rendered)["kind"] == jax_plan.kind


def test_launch_plan_hands_the_device_to_the_children_that_compute():
    plan = build_launch_plan(plan_config("torch"), "cfg.json",
                             managed_local=True, store_binary="bin/store",
                             device="cpu")
    with_device = {c.name for c in plan.commands
                   if list(c.argv[-2:]) == ["--device", "cpu"]}
    assert with_device == {"capture_server_0", "capture_server_1",
                           "consumer"}
    assert build_launch_plan(
        plan_config("torch", training={"role": "producer"}),
        "cfg.json").kind == "worker"
    # by default the store is the binary the port builds from the source
    default = build_launch_plan(plan_config("torch"), "cfg.json",
                                managed_local=True)
    assert default.commands[0].argv[0] == str(server_path())


def test_run_commands_supervises_and_tears_down(tmp_path):
    marker = tmp_path / "service_alive"
    plan = LaunchPlan(kind="supervisor", commands=(
        PlannedCommand(name="service", argv=(
            sys.executable, "-c",
            f"import time; open({str(marker)!r}, 'w').write('x'); "
            "time.sleep(600)")),
        PlannedCommand(name="worker", argv=(
            sys.executable, "-c",
            "import os, time\n"
            "deadline = time.time() + 20\n"
            f"while not os.path.exists({str(marker)!r}):\n"
            "    assert time.time() < deadline; time.sleep(0.05)"),
            expected_to_exit=True),
    ))
    spawned = []
    t0 = time.monotonic()
    assert run_commands(plan, poll_interval=0.1, grace_s=5,
                        on_spawn=lambda c, p: spawned.append(p)) == 0
    assert time.monotonic() - t0 < 30 and marker.exists()
    assert all(p.poll() is not None for p in spawned)  # torn down


def test_run_commands_passes_on_a_worker_failure():
    plan = LaunchPlan(kind="supervisor", commands=(
        PlannedCommand(name="bad", argv=(sys.executable, "-c",
                                         "raise SystemExit(3)"),
                       expected_to_exit=True),))
    assert run_commands(plan, poll_interval=0.1) == 3


def test_run_commands_fails_when_a_service_dies_before_ready():
    plan = LaunchPlan(kind="managed_supervisor", commands=(
        PlannedCommand(name="store", argv=(sys.executable, "-c",
                                           "raise SystemExit(1)"),
                       readiness=Readiness(kind="tcp",
                                           target="127.0.0.1:9",
                                           timeout_s=60)),
        PlannedCommand(name="worker", argv=(sys.executable, "-c", "pass"),
                       expected_to_exit=True),
    ))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited with 1 before it was "
                                           "ready"):
        run_commands(plan, poll_interval=0.1)
    assert time.monotonic() - t0 < 30
