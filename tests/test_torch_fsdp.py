"""EAGLE3 on a dp × fsdp mesh, and with USP, of the PyTorch port against
the JAX package, on the CPU.

The port's side runs ``cli train`` on 4 gloo CPU processes started from the
test (the ``mesh`` case of ``tests/_torch_usp_worker.py``, one launch for
all its runs); the JAX side runs its trainer on the conftest's 8 virtual
devices with ``dp_size=2``, its own dp × fsdp mesh, from the port's initial
weights. Both see the same global batch of 8 (hidden 128, S 64, vocab 2048,
draft vocab 512: the embedding and the draft head are large enough to be
sharded, the rest stays whole), fp32. A one-process port run beside them
writes the checkpoint one mesh run resumes from, and resumes from a mesh
run's. Tolerances are the JAX multihost test's (``tests/test_multihost.py:
137-146``). The runs step at a learning rate of 1e-5: Adam divides each
gradient element by its own size, so an element whose gradient is near the
rounding noise of its sum turns that noise into an update difference of up
to the learning rate, whatever the order of the sum (at 1e-3 the
one-process port and JAX end up to 3.5e-5 apart, a mesh run and one
process 4.3e-6); ``train/grad_norm`` and the losses of every step check the
gradient sums themselves."""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from specforge_tpu.application.composition import (
    build_training_run as jax_build_training_run,
)
from specforge_tpu.config.schema import Config as JaxConfig
from specforge_tpu.parallel.mesh import (
    param_partition_spec as jax_param_partition_spec,
)
from specforge_tpu_torch.application.composition import build_training_run
from specforge_tpu_torch.config.schema import load_config
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    LlamaEagle3Draft,
)
from specforge_tpu_torch.parallel.mesh import param_partition_spec
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    save_feature_file,
)
from tests.test_torch_train import write_features
from tests.test_torch_usp import RANKS, _to_jax_params, run_workers

REPO = os.path.join(os.path.dirname(__file__), "..")
V, VD, HID, S, GLOBAL = 2048, 512, 128, 64, 8
DRAFT = dict(architectures=["LlamaForCausalLMEagle3"], vocab_size=V,
             draft_vocab_size=VD, hidden_size=HID, intermediate_size=3 * HID,
             num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=1, max_position_embeddings=4096)
TOL = dict(rtol=2e-5, atol=2e-6)   # tests/test_multihost.py:137-146
SEED = 42
#: seconds for all ranks of a launch of several runs (about 30 s alone;
#: the tier-1 run shares the machine among its test workers)
MESH_TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def write_tables(root):
    """A target HF directory with bf16 head and embedding [V, HID] → the
    tables as bf16 numpy, as the port loads them (the eval pass's
    full-vocab teacher logits come out in the head's dtype, in both
    packages)."""
    rng = np.random.default_rng(7)
    tables = {"lm_head.weight": rng.normal(size=(V, HID)) * 0.2,
              "model.embed_tokens.weight": rng.normal(size=(V, HID))}
    tables = {k: v.astype(ml_dtypes.bfloat16) for k, v in tables.items()}
    os.makedirs(root, exist_ok=True)
    save_feature_file(os.path.join(root, "model.safetensors"), {
        k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
        for k, v in tables.items()})
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump({"vocab_size": V, "hidden_size": HID,
                   "tie_word_embeddings": False}, f)
    return {"target_head_weight": tables["lm_head.weight"],
            "target_embed_weight": tables["model.embed_tokens.weight"]}


def payload(workdir, run_id, batch=GLOBAL, **training):
    """A run of 2 steps of the global ``batch`` over ``train{batch}``."""
    return {
        "run_id": run_id,
        "output_dir": os.path.join(workdir, f"runs_{run_id}"),
        "model": {"draft_config": DRAFT, "compute_dtype": "float32",
                  "target_model_path": os.path.join(workdir, "target")},
        "data": {"train_data_path": os.path.join(workdir, f"train{batch}"),
                 "eval_data_path": os.path.join(workdir, "eval"),
                 "max_length": S, "num_workers": 0},
        "training": {"strategy": "eagle3", "batch_size": batch,
                     "num_epochs": 1, "log_interval": 1, "ttt_length": 2,
                     "attention_backend": "pallas", "compact_teacher": True,
                     "learning_rate": 1e-5, "save_interval": 1,
                     "seed": SEED, **training},
        "tracking": {"backend": "jsonl"},
    }


def write_run(workdir, raw):
    path = os.path.join(workdir, f"{raw['run_id']}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def records(workdir, run_id):
    path = os.path.join(workdir, f"runs_{run_id}", f"{run_id}.metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def losses(workdir, run_id, key="train/loss"):
    return [r[key] for r in records(workdir, run_id) if key in r]


def eval_metrics(workdir, run_id):
    return {k: v for r in records(workdir, run_id) for k, v in r.items()
            if k.startswith("eval/")}


def one_process(workdir, raw):
    trainer = build_training_run(load_config(write_run(workdir, raw)),
                                 device="cpu")
    trainer.fit()
    return {n: p.detach().numpy() for n, p in trainer.state.params.items()}


def jax_run(workdir, tables, run_id, batch, **training):
    """The JAX trainer's run of ``payload`` (dense attention) from the
    port's initial weights → its final weights as the port's state."""
    raw = payload(workdir, run_id, batch, attention_backend="dense",
                  **training)
    del raw["model"]["target_model_path"]
    trainer = jax_build_training_run(
        JaxConfig.model_validate(raw),
        frozen_override={k: jnp.asarray(v, jnp.bfloat16)
                         for k, v in tables.items()})
    init = LlamaEagle3Draft(Eagle3Config.from_dict(DRAFT),
                            dtype=torch.float32, device="cpu", seed=SEED)
    state = {f"draft_model.{k}": v for k, v in init.state_dict().items()}
    trainer.state = trainer.state.replace(
        params=_to_jax_params(state, trainer.state.params))
    trainer.fit()
    return {n: t.numpy() for n, t in params_from_jax(jax.device_get(
        {"params": trainer.state.params, "buffers": {}})).items()}


@pytest.fixture(scope="module")
def eagle3_runs(tmp_path_factory):
    """The JAX runs, the one-process port runs and one launch of the 4
    port ranks: dp 2 × fsdp 2 (2 steps of 8 rows, eval), dp 2 × fsdp 2
    resumed from the one-process run's step 1, and fsdp 2 × sp_ring 2 under
    USP (2 steps of 2 rows, one a batch block, eval)."""
    workdir = str(tmp_path_factory.mktemp("fsdp_eagle3"))
    for batch in (GLOBAL, 2):
        write_features(os.path.join(workdir, f"train{batch}"), 2 * batch,
                       seed=0, port_writer=True)
    write_features(os.path.join(workdir, "eval"), GLOBAL, seed=1,
                   port_writer=True)
    tables = write_tables(os.path.join(workdir, "target"))

    out = {"one": one_process(workdir, payload(workdir, "one"))}
    one_step1 = os.path.join(workdir, "runs_one", "one-step1")
    runs = [
        ("mesh", payload(workdir, "mesh", dp_size=2, fsdp_size=2)),
        ("from_one", payload(workdir, "from_one", dp_size=2, fsdp_size=2,
                             resume_from=one_step1)),
        ("usp", payload(workdir, "usp", 2, fsdp_size=2, sp_ring_size=2,
                        attention_backend="usp")),
    ]
    with open(os.path.join(workdir, "runs.json"), "w") as f:
        json.dump([{"name": name, "config": os.path.basename(
            write_run(workdir, raw))} for name, raw in runs], f)
    run_workers("mesh", workdir, MESH_TIMEOUT)
    for name, _ in runs:
        out[name] = [dict(np.load(os.path.join(
            workdir, f"{name}_rank{r}.npz"))) for r in range(RANKS)]
        out[f"{name}_roles"] = [json.load(open(os.path.join(
            workdir, f"{name}_rank{r}.json"))) for r in range(RANKS)]
    # one process resumes the mesh's step-1 checkpoint
    out["to_one"] = one_process(workdir, payload(
        workdir, "to_one", resume_from=os.path.join(
            workdir, "runs_mesh", "mesh-step1")))

    # JAX: its own dp 2 × fsdp 4 mesh for the batch of 8; the batch of 2
    # on its default mesh
    out["jax"] = jax_run(workdir, tables, "jax", GLOBAL, dp_size=2)
    out["jax2"] = jax_run(workdir, tables, "jax2", 2)
    return workdir, out


def reference(run):
    return "jax2" if run == "usp" else "jax"


@pytest.mark.parametrize("run", ["one", "mesh", "usp"])
def test_losses_match_jax(eagle3_runs, run):
    """``train/loss``, ``train/grad_norm`` and the step's accuracy and
    acceptance metrics at both steps, as the primary rank logged them."""
    workdir, _ = eagle3_runs
    keys = ("train/loss", "train/grad_norm", "train/acc_0", "train/ploss_1",
            "train/acceptance_rate_1")
    for key in keys:
        ref = losses(workdir, reference(run), key)
        assert len(ref) == 2
        np.testing.assert_allclose(losses(workdir, run, key), ref,
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("run", ["one", "mesh", "from_one", "usp",
                                 "to_one"])
def test_final_weights_match_jax(eagle3_runs, run):
    """Every trainable tensor after 2 steps (resumes: after the step from
    the other topology's step-1 checkpoint); a mesh run's ranks end with
    bit-identical gathered weights."""
    _, out = eagle3_runs
    got = out[run]
    if isinstance(got, list):
        for rank in got[1:]:
            for name in got[0]:
                assert np.array_equal(rank[name], got[0][name]), name
        got = got[0]
    ref = out[reference(run)]
    # the trainable tensors (JAX's tree also holds the frozen embedding)
    assert set(got) == set(ref) - {"draft_model.embed_tokens.weight"}
    for name, value in got.items():
        np.testing.assert_allclose(value, ref[name], err_msg=name, **TOL)


@pytest.mark.parametrize("run", ["one", "mesh", "usp"])
def test_eval_matches_jax(eagle3_runs, run):
    """The end-of-epoch eval of the dp × fsdp and the USP runs against
    JAX's dense eval of the same set."""
    workdir, _ = eagle3_runs
    ref = eval_metrics(workdir, reference(run))
    got = eval_metrics(workdir, run)
    assert set(got) == set(ref) and "eval/simulated_acc_len" in ref
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("run", ["mesh", "from_one", "usp"])
def test_mesh_roles_and_layout(eagle3_runs, run):
    """Rank (d, f, u, r) order, batch blocks, gloo, and only rank 0
    writes: its checkpoints (whole, as one process writes them) and
    markers."""
    workdir, out = eagle3_runs
    roles = out[f"{run}_roles"]
    assert [r["rc"] for r in roles] == [0] * RANKS
    assert [r["steps"] for r in roles] == [2] * RANKS
    assert [r["writes_checkpoints"] for r in roles] == [True] + [False] * 3
    assert [r["tracks"] for r in roles] == [True] + [False] * 3
    assert {r["transport"] for r in roles} == {"gloo"}
    if run == "usp":   # fsdp 2 × sp_ring 2: ranks (0, f, 0, r)
        assert [r["coords"] for r in roles] == [
            [0, 0, 0, 0], [0, 0, 0, 1], [0, 1, 0, 0], [0, 1, 0, 1]]
        assert [r["batch_block"] for r in roles] == [[0, 2], [0, 2],
                                                     [1, 2], [1, 2]]
    else:
        assert [r["batch_block"] for r in roles] == [[k, 4]
                                                     for k in range(RANKS)]
    names = sorted(os.listdir(os.path.join(workdir, f"runs_{run}")))
    steps = [2] if run == "from_one" else [1, 2]  # a resume writes step 2
    assert names == [f"{run}-step{k}" for k in steps] + [
        f"{run}.best_meta.json", f"{run}.latest", f"{run}.metrics.jsonl",
        f"{run}.vocab_mapping.npz"]


def test_rank_holds_its_shard_only(eagle3_runs):
    """Under fsdp 2 a rank's masters and Adam moments are its slices:
    half the bytes of each sharded tensor and all of each whole one, the
    same on every rank, below the one process's bytes."""
    _, out = eagle3_runs
    roles = out["mesh_roles"]
    whole = out["one"]
    dims = roles[0]["dims"]
    sharded = [n for n in whole if dims[n] is not None]
    assert {"draft_model.lm_head.weight"} <= set(sharded)
    assert dims["draft_model.embed_tokens.weight"] == 0  # frozen, bf16
    masters = sum(a.nbytes // (2 if dims[n] is not None else 1)
                  for n, a in whole.items())
    one_process_bytes = sum(a.nbytes for a in whole.values())
    for r in roles:
        assert r["bytes"]["masters"] == masters < one_process_bytes
        assert r["bytes"]["optimizer"] == 2 * masters  # mu and nu


# --------------------------------------------------------------------------
# the sharding rule
# --------------------------------------------------------------------------

def _param_shapes(draft_config, strategy):
    """Every parameter shape of the family's JAX training model built from
    ``draft_config`` (``jax.eval_shape``: nothing is allocated)."""
    from specforge_tpu.algorithms.builtin import (
        builtin_algorithm_registry as jax_registry,
    )
    from specforge_tpu.application.composition import (
        _strategy_options as jax_strategy_options,
    )

    config = JaxConfig.model_validate({
        "model": {"draft_config": draft_config},
        "data": {"max_length": 2048}, "training": {"strategy": strategy}})
    providers = jax_registry().resolve(strategy).providers
    options = jax_strategy_options(config)
    draft, cfg = providers.build_draft(draft_config, dtype=jnp.bfloat16)
    if options.get("mask_token_id") is None:
        options["mask_token_id"] = getattr(cfg, "mask_token_id", 0)
    model = providers.build_training_model(draft, options)
    shapes = jax.eval_shape(lambda: providers.init_variables(
        model, cfg, options, jax.random.PRNGKey(0), 2048))
    return [leaf.shape for leaf in jax.tree_util.tree_leaves(shapes)]


CONFIGS = {"tiny": (DRAFT, "eagle3")} | {
    name: (json.load(open(os.path.join(REPO, "configs",
                                       f"qwen3-8b-{name}.json"))), name)
    for name in ("eagle3", "domino", "peagle")}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_partition_spec_matches_jax(config):
    """The port's rule gives JAX's sharded dimension for every parameter
    shape of the tiny draft and of the Qwen3-8B drafts, at fsdp 2, 4 and 8,
    for fp32 and bf16 tensors."""
    shapes = _param_shapes(*CONFIGS[config])
    assert len(shapes) > 5
    for shape in shapes:
        for dtype in (jnp.float32, jnp.bfloat16):
            leaf = jax.ShapeDtypeStruct(shape, dtype)
            for fsdp in (2, 4, 8):
                spec = tuple(jax_param_partition_spec(leaf, fsdp))
                want = spec.index("fsdp") if "fsdp" in spec else None
                assert param_partition_spec(
                    shape, jnp.dtype(dtype).itemsize, fsdp) == want, (
                        shape, dtype, fsdp)
