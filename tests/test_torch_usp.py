"""USP sequence parallelism of the PyTorch port against the JAX package, on
the CPU.

The JAX side runs on the conftest's 8 virtual devices, the ring hop through
its Pallas kernel in interpret mode; the port's side runs on 4 gloo CPU
processes started from the test (``tests/_torch_usp_worker.py``), whose
ring hops take the plain versions of the LSE kernels. Inputs come from a
numpy seed. Each multi-process test starts its workers once, joins them
within its own time limit and kills them past it. Tolerances are those of
``tests/test_usp.py`` and ``tests/test_usp_training.py``.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from specforge_tpu.algorithms.eagle3.model import (
    OnlineEagle3Model as JaxOnlineEagle3Model,
)
from specforge_tpu.application.composition import (
    build_training_run as jax_build_training_run,
)
from specforge_tpu.config.schema import Config as JaxConfig
from specforge_tpu.models.draft.llama_eagle3 import (
    Eagle3Config as JaxEagle3Config,
)
from specforge_tpu.models.draft.llama_eagle3 import LlamaEagle3Draft as JaxDraft
from specforge_tpu.ops.attention_pallas import (
    flash_attention_lse as jax_flash_attention_lse,
)
from specforge_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from specforge_tpu.parallel.mesh import build_mesh as jax_build_mesh
from specforge_tpu.parallel.usp import usp_ttt_attention as jax_usp_attention
from specforge_tpu_torch.application.composition import build_training_run
from specforge_tpu_torch.config.schema import load_config
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    LlamaEagle3Draft,
)
from specforge_tpu_torch.ops import lse_attention_cuda as lse
from specforge_tpu_torch.parallel.usp import SequenceShard
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    save_feature_file,
)
from tests._fixtures import H as TINY_H
from tests._fixtures import V as TINY_V
from tests._fixtures import write_offline_dataset
from tests.test_multihost import TINY_DRAFT_CONFIG
from tests.test_usp_training import _payload

REPO = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__), "_torch_usp_worker.py")
RANKS = 4
WORKER_TIMEOUT = 120  # seconds for all ranks of one launch

FWD_TOL = dict(rtol=2e-5, atol=2e-5)     # tests/test_usp.py:42
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)    # tests/test_usp.py:91
B, H, D, S = 1, 4, 8, 32                 # tests/test_usp.py:16
TOPOLOGIES = ((2, 2), (1, 4), (4, 1))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread at these small shapes (several pytest
    workers share the machine)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(case: str, workdir: str,
                timeout: float = WORKER_TIMEOUT) -> None:
    """Start the 4 ranks of ``case``, wait for all of them within
    ``timeout`` seconds, kill them past it, and fail with their output if
    any failed."""
    port = _free_port()
    procs = []
    for rank in range(RANKS):
        env = dict(os.environ, SPECFORGE_COORDINATOR=f"localhost:{port}",
                   SPECFORGE_NUM_PROCESSES=str(RANKS),
                   SPECFORGE_PROCESS_ID=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.path.abspath(REPO))
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, case, workdir], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=workdir), log))
    failed = []
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                if proc.wait(timeout=timeout) != 0:
                    failed.append(rank)
            except subprocess.TimeoutExpired:
                failed.append(rank)
                break
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        logs = "\n".join(
            f"--- rank {r}\n" + open(os.path.join(workdir, f"rank{r}.log"))
            .read()[-3000:] for r in range(RANKS))
        pytest.fail(f"{case}: ranks {failed} failed or timed out\n{logs}")


# --------------------------------------------------------------------------
# (1) the LSE ring-hop op: JAX interpret mode vs the port's plain version
# --------------------------------------------------------------------------

# (S, row_off, col_off, key padding): the own chunk, an earlier one, a later
# one, a half-overlapping one, key padding, and a ragged S (the JAX kernel
# runs the ring's 256-row tiles, one block at these lengths); then the tile
# situations the card's backward kernels tell apart: offset differences
# (row_off - col_off) of +-1, +-63 and 65, a one-row chunk, a chunk whose
# rows are all dead but the last, and a key tail that pads a whole 64-key
# tile
@pytest.mark.parametrize("s,row_off,col_off,pad", [
    (48, 96, 96, 0), (48, 96, 48, 0), (48, 48, 96, 0), (48, 72, 48, 0),
    (48, 48, 48, 11), (37, 37, 0, 5),
    (48, 49, 48, 0), (48, 48, 49, 0), (70, 133, 70, 0), (70, 70, 133, 0),
    (130, 195, 130, 0), (1, 5, 5, 0), (1, 9, 3, 0), (48, 0, 47, 0),
    (130, 130, 130, 66),
])
def test_flash_attention_lse_matches_jax(s, row_off, col_off, pad):
    rng = np.random.default_rng(s + row_off + col_off + pad)
    bh, d = 3, 8
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32)
               for _ in range(3))
    valid = np.ones((bh, s), np.int32)
    if pad:
        valid[:, s - pad:] = 0
    valid[1, :3] = 0
    dout = rng.normal(size=(bh, s, d)).astype(np.float32)
    dlse = rng.normal(size=(bh, s, 1)).astype(np.float32)
    offsets = jnp.asarray([row_off, col_off], jnp.int32)
    # The JAX kernel's least tile is 8 rows, and in interpret mode a chunk
    # shorter than that reads past its end (NaN; ROADMAP Queue 3). Such a
    # chunk runs there padded to 8 rows: the pad's keys are not valid and
    # its rows' cotangents are 0, so it adds nothing to the real rows' and
    # keys' values, which are compared.
    extra = max(s, 8) - s

    def padded(x):
        return np.pad(x, ((0, 0), (0, extra)) + ((0, 0),) * (x.ndim - 2))

    @jax.jit
    def jax_fn(q, k, v, dout, dlse):
        outs, vjp = jax.vjp(
            lambda q, k, v: jax_flash_attention_lse(
                q, k, v, jnp.asarray(padded(valid)), offsets, 256, 256,
                True),
            q, k, v)
        return outs, vjp((dout, dlse))

    (j_out, j_lse), j_grads = jax_fn(
        *(jnp.asarray(padded(x)) for x in (q, k, v, dout, dlse)))
    j_out, j_lse = np.asarray(j_out)[:, :s], np.asarray(j_lse)[:, :s]
    j_grads = [np.asarray(g)[:, :s] for g in j_grads]

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse_ = lse.flash_attention_lse(tq, tk, tv, torch.from_numpy(valid),
                                        row_off, col_off)
    grads = torch.autograd.grad(
        (out * torch.from_numpy(dout)).sum()
        + (lse_ * torch.from_numpy(dlse)).sum(), (tq, tk, tv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **FWD_TOL)
    np.testing.assert_allclose(lse_.detach().numpy(), np.asarray(j_lse),
                               **FWD_TOL)
    empty = np.asarray(j_lse)[..., 0] <= -1e29
    assert np.array_equal(lse_.detach().numpy()[..., 0] == lse.NEG_INF, empty)
    if col_off - row_off >= s:  # a later chunk: nothing is allowed
        assert empty.all() and not out.detach().any()
    for got, want in zip(grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def test_lse_kernel_inputs_must_be_aligned():
    """The kernels read q, k, v and dO 16 bytes at a time (TMA, cp.async):
    the wrapper's check refuses a contiguous view that starts off a 16-byte
    boundary, and takes an aligned one."""
    bh, s, d = 2, 16, 64
    q = torch.zeros((bh, s, d), dtype=torch.bfloat16)
    valid = torch.ones((bh, s), dtype=torch.int32)
    flat = torch.zeros(q.numel() + 16, dtype=torch.bfloat16)
    aligned = flat[8 - flat.data_ptr() % 16 // 2:][:q.numel()].view(q.shape)
    shifted = flat[9 - flat.data_ptr() % 16 // 2:][:q.numel()].view(q.shape)
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 2
    lse._check_inputs(aligned, q, q, valid)
    for args in ((shifted, q, q), (q, shifted, q), (q, q, shifted)):
        with pytest.raises(ValueError, match="16-byte"):
            lse._check_inputs(*args, valid)


# --------------------------------------------------------------------------
# (2) USP attention and (3) the USP TTT model, on 4 gloo processes
# --------------------------------------------------------------------------

ATTN_CASES = [f"{u}x{r}_{n}" for u, r in TOPOLOGIES for n in (1, 3)]
MODEL_CFG = dict(vocab_size=64, draft_vocab_size=24, hidden_size=32,
                 intermediate_size=64, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=128)
MODEL_LENGTH = 3


def _attention_inputs(cid: str, rng) -> dict:
    n = int(cid.split("_")[1])
    arrays = {"q": rng.normal(size=(B, H, S, D)).astype(np.float32)}
    for i in range(n):
        arrays[f"k{i}"] = rng.normal(size=(B, H, S, D)).astype(np.float32)
        arrays[f"v{i}"] = rng.normal(size=(B, H, S, D)).astype(np.float32)
    valid = np.ones((B, S), np.int32)
    valid[0, 25:] = 0  # key padding (tests/test_usp.py:53)
    arrays["valid"] = valid
    arrays["dout"] = rng.normal(size=(B, S, H * D)).astype(np.float32)
    arrays["n"] = np.asarray(n)
    return arrays


def _jax_attention(cid: str, a: dict) -> dict:
    u, r = (int(x) for x in cid.split("_")[0].split("x"))
    mesh = jax_build_mesh(JaxMeshConfig(sp_ulysses=u, sp_ring=r),
                          devices=jax.devices()[:u * r])
    n = int(a["n"])
    keys = [jnp.asarray(a[f"k{i}"]) for i in range(n)]
    values = [jnp.asarray(a[f"v{i}"]) for i in range(n)]

    def fn(q, k0, v0):
        return jax_usp_attention(mesh, q, [k0] + keys[1:], [v0] + values[1:],
                                 key_valid=jnp.asarray(a["valid"]),
                                 impl="pallas", interpret=True)

    @jax.jit  # one program: op-by-op dispatch of the sharded vjp is slow
    def forward_and_vjp(q, k0, v0, dout):
        out, vjp = jax.vjp(fn, q, k0, v0)
        return out, vjp(dout)

    out, (dq, dk0, dv0) = forward_and_vjp(
        jnp.asarray(a["q"]), keys[0], values[0], jnp.asarray(a["dout"]))
    return {"out": np.asarray(out), "dq": np.asarray(dq),
            "dk0": np.asarray(dk0), "dv0": np.asarray(dv0)}


def _model_batch(rng) -> dict:
    """The batch of tests/test_usp.py:110-120, with a padded tail."""
    mask = np.ones((1, S), np.int32)
    mask[0, 29:] = 0
    return {
        "input_ids": rng.integers(0, 64, size=(1, S)).astype(np.int64),
        "attention_mask": mask,
        "loss_mask": (rng.random((1, S, 1)) > 0.25).astype(np.int32),
        "hidden_states": rng.normal(size=(1, S, 96)).astype(np.float32),
        "target": (rng.normal(size=(1, S, 64)) * 2).astype(np.float32),
    }


def _jax_model(batch: dict):
    """JAX OnlineEagle3Model under usp (Pallas hop in interpret mode) on a
    2×2 mesh → (its outputs, its variables)."""
    args = tuple(jnp.asarray(batch[k]) for k in (
        "input_ids", "attention_mask", "loss_mask", "hidden_states",
        "target"))
    cfg = JaxEagle3Config(**MODEL_CFG)
    dense = JaxOnlineEagle3Model(draft_model=JaxDraft(cfg, dtype=jnp.float32),
                                 length=MODEL_LENGTH)
    variables = dense.init(jax.random.PRNGKey(0), *args)
    mesh = jax_build_mesh(JaxMeshConfig(sp_ulysses=2, sp_ring=2),
                          devices=jax.devices()[:4])
    usp = JaxOnlineEagle3Model(
        draft_model=JaxDraft(cfg, dtype=jnp.float32, attention_backend="usp",
                             mesh=mesh),
        length=MODEL_LENGTH)
    before = os.environ.get("SPECFORGE_USP_HOP")
    os.environ["SPECFORGE_USP_HOP"] = "pallas"
    try:
        out = jax.jit(usp.apply)(variables, *args)
    finally:
        if before is None:
            os.environ.pop("SPECFORGE_USP_HOP")
        else:
            os.environ["SPECFORGE_USP_HOP"] = before
    return jax.device_get(out), jax.device_get(variables)


@pytest.fixture(scope="module")
def usp_runs(tmp_path_factory):
    """The JAX references and one launch of the 4 port ranks for the
    attention cases and the model."""
    workdir = str(tmp_path_factory.mktemp("usp_attention"))
    rng = np.random.default_rng(0)
    inputs, refs = {"cases": np.asarray(json.dumps(ATTN_CASES))}, {}
    for cid in ATTN_CASES:
        a = _attention_inputs(cid, rng)
        inputs.update({f"{cid}_{k}": v for k, v in a.items()})
        refs[cid] = _jax_attention(cid, a)
    np.savez(os.path.join(workdir, "attention.npz"), **inputs)
    batch = _model_batch(np.random.default_rng(0))
    model_ref, variables = _jax_model(batch)
    torch.save(params_from_jax(variables),
               os.path.join(workdir, "model_state.pt"))
    np.savez(os.path.join(workdir, "model.npz"), **batch,
             config=np.asarray(json.dumps(MODEL_CFG)),
             length=np.asarray(MODEL_LENGTH))
    run_workers("attention_and_model", workdir)
    ranks = [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
             for r in range(RANKS)]
    return refs, model_ref, ranks


def _assemble(ranks, cid, name, axis):
    """The global tensor from the ranks' chunks, in sequence order (rank
    (u, r) holds chunk r·U + u)."""
    u, r = (int(x) for x in cid.split("_")[0].split("x"))
    order = sorted(range(RANKS), key=lambda k: (k % r) * u + k // r)
    return np.concatenate([ranks[k][f"{cid}_{name}"] for k in order],
                          axis=axis)


@pytest.mark.parametrize("cid", ATTN_CASES)
def test_usp_attention_matches_jax(usp_runs, cid):
    """Forward and the q/k0/v0 gradients at topologies (2,2), (1,4), (4,1)
    with 1 and 3 branches and key padding, against JAX usp_ttt_attention
    (impl="pallas")."""
    refs, _, ranks = usp_runs
    ref = refs[cid]
    np.testing.assert_allclose(_assemble(ranks, cid, "out", 1), ref["out"],
                               **FWD_TOL)
    for name in ("dq", "dk0", "dv0"):
        np.testing.assert_allclose(_assemble(ranks, cid, name, 2), ref[name],
                                   err_msg=name, **GRAD_TOL)


def test_usp_model_matches_jax(usp_runs):
    """OnlineEagle3Model under usp on 4 ranks against JAX's, length 3 (the
    halo of 2 positions crosses the 8-position chunks): every rank returns
    the global values (tests/test_usp.py:140-151)."""
    _, ref, ranks = usp_runs
    for rank in ranks:
        np.testing.assert_allclose(rank["model_plosses"], ref.plosses,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rank["model_acceptance_rates"],
                                   ref.acceptance_rates, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(rank["model_metric_corrects"],
                                      ref.metric_corrects)
        np.testing.assert_array_equal(rank["model_metric_denoms"],
                                      ref.metric_denoms)
        np.testing.assert_allclose(rank["model_acceptance_denoms"],
                                   ref.acceptance_denoms)
        for name in rank:
            if name.startswith("model_"):
                assert np.array_equal(rank[name], ranks[0][name]), name


@pytest.mark.parametrize("refs,batch,procs", [(10, 4, 2), (12, 6, 3),
                                               (7, 2, 1)])
def test_shard_refs_for_process_matches_jax(refs, batch, procs):
    from specforge_tpu.parallel.multihost import (
        shard_refs_for_process as jax_shard_refs,
    )
    from specforge_tpu_torch.parallel.multihost import shard_refs_for_process

    items = [f"ref{i}" for i in range(refs)]
    for p in range(procs):
        assert shard_refs_for_process(items, batch, proc_index=p,
                                      proc_count=procs) == jax_shard_refs(
            items, batch, proc_index=p, proc_count=procs)


def test_mesh_groups_follow_the_jax_device_order():
    """Rank (d, f, u, r) sits where JAX's build_mesh puts device
    ``((d·fsdp + f)·U + u)·R + r``; the Ulysses groups vary u, the ring
    groups r, the sequence groups both."""
    from specforge_tpu_torch.parallel.mesh import MeshConfig, _groups

    cfg = MeshConfig(dp=2, fsdp=1, sp_ulysses=2, sp_ring=3)
    grid = np.arange(cfg.world_size).reshape(cfg.shape)
    assert all(cfg.rank_of(*idx) == grid[idx] == cfg.rank_of(
        *cfg.coords(int(grid[idx]))) for idx in np.ndindex(*cfg.shape))
    assert _groups(cfg, (2,)) == [sorted(grid[d, 0, :, r].tolist())
                                  for d in range(2) for r in range(3)]
    assert _groups(cfg, (3,)) == [sorted(grid[d, 0, u, :].tolist())
                                  for d in range(2) for u in range(2)]
    assert _groups(cfg, (2, 3)) == [sorted(grid[d, 0].ravel().tolist())
                                    for d in range(2)]


def _places(hosts, cards, device_type="cuda"):
    """One RankPlace per rank: ``hosts[i]`` and the card ids rank i sees."""
    from specforge_tpu_torch.parallel.multihost import RankPlace

    return [RankPlace(h, device_type, tuple(c)) for h, c in zip(hosts, cards)]


EIGHT = [f"gpu{i}" for i in range(8)]


@pytest.mark.parametrize("places,backend,cards", [
    # CPU ranks
    (_places(["a"] * 4, [()] * 4, "cpu"), "gloo", [None] * 4),
    # one host, a card per rank
    (_places(["a"] * 4, [EIGHT[:4]] * 4), "nccl", [0, 1, 2, 3]),
    # a launcher that pins one card per process (CUDA_VISIBLE_DEVICES)
    (_places(["a"] * 4, [[g] for g in EIGHT[:4]]), "nccl", [0] * 4),
    # the JAX multi-host recipe: 2 hosts x 8 cards, 16 ranks
    (_places(["a"] * 8 + ["b"] * 8, [EIGHT] * 8 + [[f"b{g}" for g in EIGHT]]
             * 8), "nccl", list(range(8)) * 2),
    # four ranks on the one card of their host
    (_places(["a"] * 4, [["gpu0"]] * 4), "gloo", [0] * 4),
])
def test_transport_rule(places, backend, cards):
    from specforge_tpu_torch.parallel.multihost import plan_transport

    assert plan_transport(places) == (backend, cards)


@pytest.mark.parametrize("places,match", [
    # fewer cards than ranks on the host, more than one
    (_places(["a"] * 4, [EIGHT[:2]] * 4), "sees 2 CUDA cards for 4 ranks"),
    # two ranks pinned to one card, two to cards of their own
    (_places(["a"] * 4, [["gpu0"], ["gpu0"], ["gpu1"], ["gpu2"]]),
     "share a card and others do not"),
    # CPU and CUDA ranks
    (_places(["a"] * 2, [()] * 2, "cpu") + _places(["a"] * 2, [["gpu0"]] * 2),
     "mixed device types"),
])
def test_transport_rule_refuses(places, match):
    from specforge_tpu_torch.parallel.multihost import plan_transport

    with pytest.raises(ValueError, match=match):
        plan_transport(places)


def test_sequence_shard_windows():
    """Chunk r·U + u and its halo, cut from the global batch on the host
    (one position more for a shift left after the cut), zero past the
    global end."""
    class _Mesh:
        sp_size, chunk_index = 4, 3

    shard = SequenceShard.of(_Mesh, 32, 2)
    x = torch.arange(32).reshape(1, 32)
    local = shard.take(x)
    assert local.tolist() == [list(range(24, 32))]
    assert shard.take(x, lookahead=1).tolist() == local.tolist()
    assert shard.chunk(local).tolist() == [list(range(24, 32))]
    assert shard.window(local).tolist() == [list(range(24, 32)) + [0, 0]]
    _Mesh.chunk_index = 1
    shard = SequenceShard.of(_Mesh, 32, 2)
    local = shard.take(x)
    assert local.tolist() == [list(range(8, 18))]
    assert shard.chunk(local).tolist() == [list(range(8, 16))]
    assert shard.window(local).tolist() == [list(range(8, 18))]
    ahead = shard.take(x, lookahead=1)
    assert ahead.tolist() == [list(range(8, 19))]
    assert shard.trim(ahead).tolist() == local.tolist()
    whole = SequenceShard.of(None, 32, 2)
    assert whole.take(x, lookahead=1) is x and whole.window(x) is x
    assert whole.chunk(x).shape == (1, 32)
    with pytest.raises(ValueError, match="divisible"):
        SequenceShard.of(_Mesh, 30, 2)


# --------------------------------------------------------------------------
# (4) cli train on 4 ranks against the JAX dense run
# --------------------------------------------------------------------------

def _to_jax_params(state: dict, template):
    """The port's state_dict as the JAX params tree of ``template`` (the
    inverse of ``params_from_jax``); the frozen embedding keeps the
    template's (target-copied) value."""
    def walk(node, prefix):
        out = {}
        for key, leaf in node.items():
            name = f"{prefix}{key}"
            if isinstance(leaf, dict):
                out[key] = walk(leaf, name + ".")
                continue
            stem = name.rsplit(".", 1)[0]
            if key == "embedding":
                out[key] = leaf
                continue
            value = state[f"{stem}.weight"].numpy()
            value = value.T if key == "kernel" else value
            out[key] = jax.device_put(jnp.asarray(value, leaf.dtype),
                                      leaf.sharding)
        return out

    return walk(template, "")


def test_usp_cli_train_matches_jax(tmp_path):
    """``cli train`` under usp on 4 gloo ranks (2×2) against the JAX dense
    run of tests/test_usp_training.py (4 steps, TTT 2, fp32), from the same
    initial weights: losses and final weights; every rank ends with the
    same bits, and only rank 0 writes checkpoints and metrics."""
    workdir = str(tmp_path)
    write_offline_dataset(os.path.join(workdir, "data"), n=4)
    rng = np.random.default_rng(7)
    tables = {
        "lm_head.weight": rng.normal(size=(TINY_V, TINY_H)),
        "model.embed_tokens.weight": rng.normal(size=(TINY_V, TINY_H)),
    }
    tables = {k: v.astype(ml_dtypes.bfloat16) for k, v in tables.items()}
    target = tmp_path / "target"
    target.mkdir()
    save_feature_file(str(target / "model.safetensors"), {
        k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
        for k, v in tables.items()})
    (target / "config.json").write_text(json.dumps(
        {"vocab_size": TINY_V, "hidden_size": TINY_H,
         "tie_word_embeddings": False}))

    # the port's ranks (the JAX payload, under usp on a 2×2 grid)
    raw = _payload(workdir, "usp", "runs_port")
    raw["model"]["target_model_path"] = str(target)
    raw["training"].update(sp_ulysses_size=2, sp_ring_size=2,
                           compact_teacher=True, save_interval=2)
    (tmp_path / "run.json").write_text(json.dumps(raw))
    run_workers("train", workdir)

    # the JAX dense run from the port's initial weights
    jax_raw = _payload(workdir, "dense", "runs_dense")
    jax_raw["training"]["compact_teacher"] = True
    jax_trainer = jax_build_training_run(
        JaxConfig.model_validate(jax_raw),
        frozen_override={
            "target_head_weight": jnp.asarray(
                tables["lm_head.weight"].astype(np.float32)),
            "target_embed_weight": jnp.asarray(
                tables["model.embed_tokens.weight"].astype(np.float32)),
        })
    init = LlamaEagle3Draft(Eagle3Config.from_dict(TINY_DRAFT_CONFIG),
                            dtype=torch.float32, device="cpu",
                            seed=raw["training"].get("seed", 42))
    state = {f"draft_model.{k}": v for k, v in init.state_dict().items()}
    jax_trainer.state = jax_trainer.state.replace(
        params=_to_jax_params(state, jax_trainer.state.params))
    jax_trainer.fit()

    def losses(out_dir, run_id):
        path = os.path.join(workdir, out_dir, f"{run_id}.metrics.jsonl")
        return [json.loads(line)["train/loss"] for line in open(path)
                if "train/loss" in json.loads(line)]

    # one record per step: only rank 0 tracks
    port_losses = losses("runs_port", "usp-usp")
    jax_losses = losses("runs_dense", "usp-dense")
    assert len(port_losses) == len(jax_losses) == 4
    np.testing.assert_allclose(port_losses, jax_losses, rtol=2e-5, atol=1e-5)

    ranks = [np.load(os.path.join(workdir, f"rank{r}.npz"))
             for r in range(RANKS)]
    roles = [json.load(open(os.path.join(workdir, f"rank{r}.json")))
             for r in range(RANKS)]
    assert [r["rc"] for r in roles] == [0] * RANKS
    assert [r["steps"] for r in roles] == [4] * RANKS
    assert [r["writes_checkpoints"] for r in roles] == [True] + [False] * 3
    assert [r["tracks"] for r in roles] == [True] + [False] * 3
    assert sorted(r["chunk"] for r in roles) == [0, 1, 2, 3]
    assert {r["transport"] for r in roles} == {"gloo"}
    for rank in ranks[1:]:
        for name in ranks[0].files:
            assert np.array_equal(rank[name], ranks[0][name]), name
    jax_final = params_from_jax(jax.device_get(
        {"params": jax_trainer.state.params, "buffers": {}}))
    for name in ranks[0].files:
        np.testing.assert_allclose(ranks[0][name], jax_final[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    runs = tmp_path / "runs_port"
    assert sorted(p.name for p in runs.iterdir()) == [
        "usp-usp-step2", "usp-usp-step4", "usp-usp.latest",
        "usp-usp.metrics.jsonl", "usp-usp.vocab_mapping.npz"]


# --------------------------------------------------------------------------
# (5) what the composition refuses
# --------------------------------------------------------------------------

def _port_config(tmp_path, **training):
    write_offline_dataset(str(tmp_path / "data"), n=2)
    raw = _payload(str(tmp_path), "usp", "runs")
    raw["training"].update(sp_ulysses_size=2, sp_ring_size=2, **training)
    path = tmp_path / "run.json"
    path.write_text(json.dumps(raw))
    return raw, path


def test_usp_max_length_must_divide(tmp_path):
    raw, path = _port_config(tmp_path)
    with pytest.raises(ValueError, match="divisible"):
        build_training_run(load_config(str(path), [
            f"data.max_length={raw['data']['max_length'] - 1}"]),
            frozen_override={}, device="cpu")


def test_usp_needs_one_process_per_rank(tmp_path):
    _, path = _port_config(tmp_path)
    with pytest.raises(ValueError, match="one process per rank"):
        build_training_run(load_config(str(path)), frozen_override={},
                           device="cpu")


@pytest.mark.parametrize("override", ["training.dp_size=2",
                                      "training.fsdp_size=2"])
def test_usp_mesh_needs_one_process_per_rank(tmp_path, override):
    """USP under dp or fsdp (one row a batch block) in one process: the
    mesh of 2 × 2 × 2 ranks needs that many processes."""
    _, path = _port_config(tmp_path)
    with pytest.raises(ValueError, match="one process per rank, 8, have 1"):
        build_training_run(load_config(str(path), [
            override, "training.batch_size=2"]),
            frozen_override={}, device="cpu")
