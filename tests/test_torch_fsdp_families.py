"""P-EAGLE at fsdp 4 and Domino at dp 2 × fsdp 2, the port's ``cli train``
on 4 gloo CPU processes (one launch of ``tests/_torch_usp_worker.py``'s
``mesh`` case) against the JAX trainer of the same global batch on the
conftest's 8 virtual devices, on the CPU; in the same launch DFlash and
DSpark (fused and unfused objective) at dp 2 × fsdp 2 against the port in
one process, drawing their anchors from the port's own sampler, which
draws for the global batch.

Both sides start from the port's initial weights (its seeded draft, the
target embedding copied in) and the same bf16 target tables. The JAX
strategies draw their anchors and COD samples from ``fold_in(PRNGKey(seed),
step)`` over the global batch; the test draws the same uniform values and
hands them to the port's ranks, each of which keeps its batch block's rows
(the port's own sampler draws for the global batch the same way, from its
generator). P-EAGLE runs factored Adam with ``adam_b1 = 0`` and the
row-sparse embedding update. Each run takes 2 optimizer steps of 2
micro-steps. Hidden 128, S 64,
vocab 2048 (the embedding and the larger matrices are sharded, the rest
whole), fp32, a learning rate of 1e-5 (``tests/test_torch_fsdp.py`` says
why). Tolerances: the JAX multihost test's."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.application.composition import (
    build_training_run as jax_build_training_run,
)
from specforge_tpu.config.schema import Config as JaxConfig
from specforge_tpu_torch.application.composition import build_training_run
from specforge_tpu_torch.config.schema import load_config
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.parallel.fsdp import state_bytes
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    save_feature_file,
)
from tests.test_torch_fsdp import MESH_TIMEOUT, TOL, write_tables
from tests.test_torch_train import write_features
from tests.test_torch_usp import RANKS, run_workers

V, HID, S, GLOBAL, SEED = 2048, 128, 64, 4, 3
COMMON = dict(vocab_size=V, hidden_size=HID, intermediate_size=256,
              num_attention_heads=4, num_key_value_heads=2, head_dim=32,
              num_hidden_layers=2, max_position_embeddings=256)
PEAGLE = dict(COMMON, architectures=["PEagleDraftModel"],
              draft_vocab_size=512)
DOMINO = dict(COMMON, architectures=["DominoDraftModel"],
              num_target_layers=8, block_size=4, mask_token_id=V - 1,
              projector_type="domino", emb_dim=32, gru_hidden_dim=32,
              pure_draft_prefix_len=1, shift_label=True)
DFLASH = dict(COMMON, architectures=["DFlashDraftModel"],
              num_target_layers=8, block_size=4, mask_token_id=V - 1)
DSPARK = dict(DFLASH, architectures=["DSparkDraftModel"],
              projector_type="dspark", markov_rank=8,
              markov_head_type="gated", enable_confidence_head=True)
DEPTHS = 3
#: (draft, training options, accumulation, JAX's attention: None for a run
#: held against the port in one process)
FAMILIES = {
    "peagle": (PEAGLE, dict(num_depths=DEPTHS, down_sample_ratio=0.5,
                            down_sample_ratio_min=0.2,
                            factored_second_moments=True, adam_b1=0.0,
                            row_sparse_embedding=True), 2, "dense"),
    "domino": (DOMINO, dict(num_anchors=8, objective_chunk_blocks=2), 2,
               "chunked"),
    "dflash": (DFLASH, dict(num_anchors=8, objective_chunk_blocks=2), 2,
               None),
    "dspark": (DSPARK, dict(num_anchors=8, objective_chunk_blocks=2), 2,
               None),
    "dspark_unfused": (DSPARK, dict(num_anchors=8, objective_chunk_blocks=2,
                                    fused_vocab_objective=False), 2, None),
}
MESH = {"peagle": dict(fsdp_size=4)}
DP_FSDP = dict(dp_size=2, fsdp_size=2)
#: each family's ratio metric beside the loss
RATIO = {"dflash": "train/acc", "dspark": "train/tau_probabilistic",
         "dspark_unfused": "train/l1_loss"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def write_dflash_features(root, n, seed):
    """The DFlash family's features: ``hidden_states`` of its 2 capture
    layers, and the target's last hidden state (DSpark's teacher)."""
    os.makedirs(root, exist_ok=True)
    gen = torch.Generator().manual_seed(seed)
    for i in range(n):
        m = int(torch.randint(40, S + 1, (1,), generator=gen))
        mask = torch.zeros(m, dtype=torch.int64)
        mask[m // 4:] = 1
        save_feature_file(os.path.join(root, f"sample-{i:04d}.sft"), {
            "input_ids": torch.randint(0, V - 1, (m,), generator=gen),
            "loss_mask": mask,
            "hidden_states": torch.randn(m, 2 * HID, generator=gen).to(
                torch.bfloat16),
            "target_last_hidden_states": torch.randn(
                m, HID, generator=gen).to(torch.bfloat16)},
            {"target_repr": "hidden_state"})


def payload(workdir, kind, run_id, attention=None, **training):
    draft, options, accum, _ = FAMILIES[kind]
    draft = dict(draft)
    if attention is not None:
        draft["attention_backend"] = attention
    return {
        "run_id": run_id,
        "output_dir": os.path.join(workdir, f"runs_{run_id}"),
        "model": {"draft_config": draft, "compute_dtype": "float32",
                  "target_model_path": os.path.join(workdir, "target")},
        "data": {"train_data_path": os.path.join(
            workdir, "peagle" if kind == "peagle" else "dflash"),
                 "max_length": S, "num_workers": 0},
        "training": {"strategy": kind.split("_")[0], "batch_size": GLOBAL,
                     "accumulation_steps": accum, "num_epochs": 1,
                     "log_interval": 1, "learning_rate": 1e-5,
                     "warmup_ratio": 0.0, "seed": SEED, **options,
                     **training},
        "tracking": {"backend": "jsonl"},
    }


def to_jax(state, template):
    """The port's state_dict as the JAX params tree of ``template`` (the
    inverse of ``params_from_jax``)."""
    def walk(node, prefix):
        out = {}
        for key, leaf in node.items():
            name = f"{prefix}{key}"
            if isinstance(leaf, dict):
                out[key] = walk(leaf, name + ".")
                continue
            stem = name.rsplit(".", 1)[0]
            if key == "kernel":
                value = state[f"{stem}.weight"].numpy().T
            elif key in ("embedding", "weight"):
                value = state[f"{stem}.weight"].numpy()
            else:
                value = state[name].numpy()
            out[key] = jax.device_put(jnp.asarray(value, leaf.dtype),
                                      leaf.sharding)
        return out

    return walk(template, "")


def jax_uniforms(kind, steps):
    """The uniform values JAX's strategy draws at each step for the global
    batch: anchors [B, S - 1], or COD [D - 1, B, S] (a key a row, split
    once a depth)."""
    out = {}
    for step in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
        if kind == "domino":
            out[f"anchors_{step}"] = np.asarray(
                jax.random.uniform(key, (GLOBAL, S - 1)))
            continue
        rows = []
        for row_key in jax.random.split(key, GLOBAL):
            depths = []
            for _ in range(1, DEPTHS):
                row_key, sub = jax.random.split(row_key)
                depths.append(np.asarray(jax.random.uniform(sub, (S,))))
            rows.append(depths)
        out[f"cod_{step}"] = np.asarray(rows).transpose(1, 0, 2)
    return out


def metric(workdir, run_id, key):
    path = os.path.join(workdir, f"runs_{run_id}", f"{run_id}.metrics.jsonl")
    with open(path) as f:
        return [r[key] for r in map(json.loads, f) if key in r]


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("fsdp_families"))
    tables = write_tables(os.path.join(workdir, "target"))
    write_features(os.path.join(workdir, "peagle"), 4 * GLOBAL, seed=2,
                   port_writer=True)
    write_dflash_features(os.path.join(workdir, "dflash"), 4 * GLOBAL, 4)
    runs, out = [], {}
    for kind, (*_, accum, attention) in FAMILIES.items():
        raw = payload(workdir, kind, kind, **MESH.get(kind, DP_FSDP))
        path = os.path.join(workdir, f"{kind}.json")
        with open(path, "w") as f:
            json.dump(raw, f)
        runs.append({"name": kind, "config": f"{kind}.json"})
        if attention is not None:
            np.savez(os.path.join(workdir, f"{kind}_uniforms.npz"),
                     **jax_uniforms(kind, 2))
            runs[-1]["uniforms"] = f"{kind}_uniforms.npz"
    with open(os.path.join(workdir, "runs.json"), "w") as f:
        json.dump(runs, f)
    run_workers("mesh", workdir, MESH_TIMEOUT)

    for kind, (_, _, _, attention) in FAMILIES.items():
        out[kind] = [dict(np.load(os.path.join(
            workdir, f"{kind}_rank{r}.npz"))) for r in range(RANKS)]
        out[f"{kind}_roles"] = [json.load(open(os.path.join(
            workdir, f"{kind}_rank{r}.json"))) for r in range(RANKS)]
        # the port's initial state, whole, from one process
        path = os.path.join(workdir, f"{kind}_one.json")
        with open(path, "w") as f:
            json.dump(payload(workdir, kind, f"{kind}_one"), f)
        one = build_training_run(load_config(path), device="cpu")
        out[f"{kind}_one_bytes"] = state_bytes(one.state)
        out[f"{kind}_one_shapes"] = {n: tuple(p.shape)
                                     for n, p in one.state.params.items()}
        if attention is None:  # the port in one process is the reference
            one.fit()
            out[f"{kind}_ref"] = {n: p.detach().numpy()
                                  for n, p in one.state.params.items()}
            continue
        init = one.strategy.model.state_dict()
        # JAX: its trainer on its own mesh from those weights
        jax_raw = payload(workdir, kind, f"{kind}_jax", attention)
        del jax_raw["model"]["target_model_path"]
        trainer = jax_build_training_run(
            JaxConfig.model_validate(jax_raw),
            frozen_override={k: jnp.asarray(v, jnp.bfloat16)
                             for k, v in tables.items()})
        trainer.state = trainer.state.replace(
            params=to_jax(init, trainer.state.params))
        trainer.fit()
        out[f"{kind}_ref"] = {n: t.numpy() for n, t in params_from_jax(
            jax.device_get({"params": trainer.state.params,
                            "buffers": {}})).items()}
    return workdir, out


def reference(kind):
    return f"{kind}_jax" if FAMILIES[kind][3] else f"{kind}_one"


@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_steps_match_jax(family_runs, kind):
    """``train/loss``, ``train/grad_norm``, the accuracy (and a ratio
    metric) at both optimizer steps, as the primary rank logged them,
    against JAX (P-EAGLE, Domino) or the port in one process."""
    workdir, _ = family_runs
    for key in ("train/loss", "train/grad_norm", "train/accuracy",
                RATIO.get(kind, "train/accuracy")):
        ref = metric(workdir, reference(kind), key)
        assert len(ref) == 2, key
        np.testing.assert_allclose(metric(workdir, kind, key), ref,
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_final_weights_match_jax(family_runs, kind):
    """Every trainable tensor after 2 steps, gathered whole, bit-identical
    on every rank (P-EAGLE's embedding took the row-sparse update from the
    rows of all 4 ranks)."""
    _, out = family_runs
    ranks, ref = out[kind], out[f"{kind}_ref"]
    for rank in ranks[1:]:
        for name in ranks[0]:
            assert np.array_equal(rank[name], ranks[0][name]), name
    assert set(ranks[0]) == set(ref)
    for name, value in ranks[0].items():
        np.testing.assert_allclose(value, ref[name], err_msg=name, **TOL)


@pytest.mark.parametrize("kind", sorted(FAMILIES))
def test_layout_and_shard_bytes(family_runs, kind):
    """The batch blocks of the layout, only rank 0 writes, and each rank
    holds its slices: the masters' bytes follow the sharding rule, the
    optimizer state is below the one process's."""
    _, out = family_runs
    roles = out[f"{kind}_roles"]
    fsdp = MESH.get(kind, DP_FSDP)["fsdp_size"]
    assert [r["rc"] for r in roles] == [0] * RANKS
    assert [r["batch_block"] for r in roles] == [[k, 4] for k in range(4)]
    assert [r["writes_checkpoints"] for r in roles] == [True] + [False] * 3
    shapes, dims = out[f"{kind}_one_shapes"], roles[0]["dims"]
    assert any(dims[n] is not None for n in shapes)
    assert any(dims[n] is None for n in shapes)
    masters = sum(4 * int(np.prod(s)) // (fsdp if dims[n] is not None else 1)
                  for n, s in shapes.items())
    one = out[f"{kind}_one_bytes"]
    for r in roles:
        assert r["bytes"]["masters"] == masters < one["masters"]
        assert r["bytes"]["optimizer"] < one["optimizer"]
