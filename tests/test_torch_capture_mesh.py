"""The port's capture mesh against one process and the JAX package, on the
CPU over gloo.

Each launch starts 2 or 4 rank processes (``tests/_torch_capture_worker.py``,
or the port's own commands, which start their ranks themselves), waits for
them within ``RANK_TIMEOUT`` and kills them past it:

- a dense target sharded over the ranks (its leaves large enough for
  ``param_partition_spec`` to cut) captures bit-identical features to the
  port's one-process capture on every rank, within 2e-5 of JAX's sharded
  runner (``tests/test_capture_pipeline.py:212``), each rank holding only
  its slices, and only rank 0 writes files;
- a tiny qwen3_moe target under ``moe_impl="ep"`` captures within 5e-4 of
  JAX's EP capture (``tests/test_moe_ep.py:116``), a factor that fits
  changes nothing, and one that overflows aborts the runner with JAX's
  overflow count;
- ``prepare --shard-over-devices`` writes the one-process files, with and
  without ``--moe-impl ep``, and exits non-zero when a rank aborts;
- a 2-rank ``capture_server_main`` answers as a one-device engine does
  (``tests/test_online_capture_sharded.py:121``) and SIGTERM stops every
  rank.
"""

import base64
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from specforge_tpu.models.target import transformer as jax_tf
from specforge_tpu.offline_capture.capture import (
    OfflineCaptureConfig as JaxCaptureConfig,
)
from specforge_tpu.offline_capture.capture import (
    OfflineCaptureRunner as JaxCaptureRunner,
)
from specforge_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from specforge_tpu.parallel.mesh import build_mesh as jax_build_mesh
from specforge_tpu_torch.models.target import transformer as pt_tf
from specforge_tpu_torch.offline_capture.capture import (
    OfflineCaptureConfig,
    OfflineCaptureRunner,
)
from specforge_tpu_torch.parallel.mesh import param_partition_spec
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    load_feature_file,
)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORKER = os.path.join(os.path.dirname(__file__), "_torch_capture_worker.py")
RANK_TIMEOUT = 120  # seconds for all ranks of one launch
FSDP_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_capture_pipeline.py:254
EP_TOL = dict(rtol=5e-4, atol=5e-4)    # tests/test_moe_ep.py:151
LAYERS = (0, 1, 1)
V, B, S = 1024, 2, 24
#: capacity factors of the EP runs: one every rank's rows fit, one that
#: drops rows (JAX counts the same overflow at each)
FITS, OVERFLOWS = 2.0, 0.25


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO, **extra)


@pytest.fixture(scope="module")
def targets(tmp_path_factory):
    """(dense, moe) HF directories written by ``transformers``: a Qwen3
    whose projections are cut by ``param_partition_spec`` (each at least
    ``MIN_SHARD_BYTES`` in fp32), saved as several shards, and the tiny
    Qwen3-MoE of ``tests/test_moe_ep.py``."""
    import transformers

    root = tmp_path_factory.mktemp("mesh_targets")
    torch.manual_seed(0)
    transformers.Qwen3ForCausalLM(transformers.Qwen3Config(
        vocab_size=V, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=64, max_position_embeddings=256,
        tie_word_embeddings=False)).eval().save_pretrained(
        root / "dense", safe_serialization=True, max_shard_size="1MB")
    torch.manual_seed(3)
    transformers.Qwen3MoeForCausalLM(transformers.Qwen3MoeConfig(
        vocab_size=V, hidden_size=32, intermediate_size=64,
        moe_intermediate_size=24, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        num_experts=8, num_experts_per_tok=2, decoder_sparse_step=1,
        norm_topk_prob=True, max_position_embeddings=256,
    )).eval().save_pretrained(root / "moe", safe_serialization=True)
    return str(root / "dense"), str(root / "moe")


def batch():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, size=(B, S))
    mask = np.ones((B, S), np.int64)
    mask[1, 15:] = 0
    return ids, mask


def run_ranks(n: int, workdir: str) -> list:
    """Start ``n`` worker ranks, wait for all within RANK_TIMEOUT (killing
    them past it) → each rank's results; fail with their logs if one
    failed."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = rank_env(SPECFORGE_COORDINATOR=f"localhost:{port}",
                       SPECFORGE_NUM_PROCESSES=str(n),
                       SPECFORGE_PROCESS_ID=str(rank))
        log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, workdir], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=workdir), log))
    failed = []
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                if proc.wait(timeout=max(deadline - time.monotonic(), 1)):
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
        logs = "\n".join(f"--- rank {r}\n" + open(os.path.join(
            workdir, f"rank{r}.log")).read()[-3000:] for r in range(n))
        pytest.fail(f"ranks {failed} failed or timed out\n{logs}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"))
            for r in range(n)]


def jax_capture(root, ranks, **kwargs):
    """JAX's runner on an fsdp mesh of ``ranks`` devices, fp32 weights."""
    cfg = jax_tf.TargetConfig.from_file(root)
    params = jax_tf.load_target_params(root, cfg, dtype=jnp.float32)
    return JaxCaptureRunner(
        JaxCaptureConfig(root, "unused", LAYERS, S, B), target_config=cfg,
        target_params=params,
        mesh=jax_build_mesh(JaxMeshConfig(fsdp=ranks),
                            devices=jax.devices()[:ranks]),
        **kwargs)


def one_process(root, ids, mask):
    tc = pt_tf.TargetConfig.from_file(root)
    runner = OfflineCaptureRunner(
        OfflineCaptureConfig(root, "unused", LAYERS, S, B), target_config=tc,
        target_params=pt_tf.load_target_params(root, tc, torch.float32,
                                               "cpu"))
    return runner._run_batch(ids, mask), runner.params


@pytest.mark.parametrize("ranks", [2, 4])
def test_capture_mesh_against_one_process_and_jax(targets, tmp_path, ranks):
    dense, moe = targets
    ids, mask = batch()
    np.savez(tmp_path / "batch.npz", ids=ids, mask=mask)
    (tmp_path / "case.json").write_text(json.dumps({
        "dense": dense, "moe": moe, "layers": LAYERS, "fits": FITS,
        "overflows": OVERFLOWS}))
    results = run_ranks(ranks, str(tmp_path))
    assert [r["transport"] for r in results] == ["gloo"] * ranks
    valid = mask.astype(bool)

    # dense fsdp: bit for bit one process's, on every rank
    (aux1, last1), whole = one_process(dense, ids, mask)
    for r in results:
        assert torch.equal(r["dense"][0], aux1)
        assert torch.equal(r["dense"][1], last1)
        assert r["gathered"]["bytes"] > 0
        assert r["lookups_equal"]
    jax_runner = jax_capture(dense, ranks)
    aux_j, last_j = jax_runner._run_batch(ids.astype(np.int32),
                                          mask.astype(np.int32))
    np.testing.assert_allclose(results[1]["dense"][0].numpy()[valid],
                               aux_j[valid], **FSDP_TOL)
    np.testing.assert_allclose(results[1]["dense"][1].numpy()[valid],
                               last_j[valid], **FSDP_TOL)
    # each rank holds its slices: the rule's bytes, below one process's
    expected, total, cut = 0, 0, 0
    for value in whole.values():
        nbytes = value.numel() * value.element_size()
        total += nbytes
        dim = param_partition_spec(value.shape, value.element_size(), ranks)
        expected += nbytes if dim is None else nbytes // ranks
        cut += dim is not None
    assert cut >= 9  # every projection and the embedding and head
    assert [r["resident_bytes"] for r in results] == [expected] * ranks
    assert expected < total
    # rank 0 alone writes; every rank returns the same paths
    assert results[0]["written"] == results[0]["paths"]
    assert all(r["written"] == [] for r in results[1:])
    assert all(r["paths"] == results[0]["paths"] for r in results)
    assert sorted(os.listdir(tmp_path / "files")) == sorted(
        results[0]["paths"])

    # EP on the MoE target against JAX's EP capture
    e_local = 8 // ranks
    keys = results[0]["ep_keys"]
    assert keys["model.layers.0.mlp.experts.gate_stacked"] == (e_local, 32,
                                                              24)
    assert not any(".experts.0." in k for k in keys)
    for factor, name in ((None, "ep"), (FITS, "ep_fits"),
                         (OVERFLOWS, "ep_overflows")):
        runner = jax_capture(moe, ranks, moe_impl="ep",
                             moe_capacity_factor=factor)
        aux_j, last_j, overflow = runner._forward(
            runner.params, jnp.asarray(ids, jnp.int32),
            jnp.asarray(mask, jnp.int32))
        got = [r[name] for r in results]
        if name == "ep_overflows":
            assert int(overflow) > 0
            want = (f"EP MoE capacity overflow: {int(overflow)} expert "
                    "assignments were not computed")
            assert all(g.startswith(want) for g in got), got
            continue
        assert int(overflow) == 0
        for aux, last in got:
            assert torch.equal(aux, got[0][0]) and torch.equal(last,
                                                               got[0][1])
            np.testing.assert_allclose(aux.numpy()[valid],
                                       np.asarray(aux_j)[valid], **EP_TOL)
            np.testing.assert_allclose(last.numpy()[valid],
                                       np.asarray(last_j)[valid], **EP_TOL)
    assert all(torch.equal(r["ep_fits"][0], r["ep"][0]) for r in results)


def write_records(path, ids, mask):
    with open(path, "w") as f:
        for row, m in zip(ids, mask):
            n = int(m.sum())
            f.write(json.dumps({"input_ids": row[:n].tolist(),
                                "loss_mask": [1] * n}) + "\n")


def prepare(args, timeout=RANK_TIMEOUT):
    proc = subprocess.run(
        [sys.executable, "-m", "specforge_tpu_torch.offline_capture.prepare",
         *args, "--device", "cpu", "--max-length", str(S),
         "--capture-layers", *map(str, LAYERS)],
        cwd=REPO, env=rank_env(), capture_output=True, text=True,
        timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr


def test_prepare_shard_over_devices(targets, tmp_path):
    """``prepare --shard-over-devices 2`` starts its second rank itself and
    writes the one-process files bit for bit; with ``--moe-impl ep`` the
    MoE target's files match the gathered capture's in bf16; a capacity
    factor that overflows ends every rank and the command exits
    non-zero."""
    dense, moe = targets
    ids, mask = batch()
    write_records(tmp_path / "data.jsonl", ids, mask)
    runs = {}
    for name, target, extra in (
            ("one", dense, []),
            ("mesh", dense, ["--shard-over-devices", "2"]),
            ("gathered", moe, []),
            ("ep", moe, ["--shard-over-devices", "2", "--moe-impl", "ep"])):
        rc, out = prepare(["--target-model", target, "--data",
                           str(tmp_path / "data.jsonl"), "--output-dir",
                           str(tmp_path / name), *extra])
        assert rc == 0, out
        runs[name] = {f: load_feature_file(str(tmp_path / name / f))[0]
                      for f in sorted(os.listdir(tmp_path / name))}
    assert "sharding the target over 2 ranks (gloo)" in out
    assert list(runs["mesh"]) == list(runs["one"]) and len(runs["one"]) == B
    for f, tensors in runs["one"].items():
        for key, value in tensors.items():
            assert torch.equal(runs["mesh"][f][key], value), (f, key)
    for f, tensors in runs["gathered"].items():
        for key in ("hidden_state", "target"):
            np.testing.assert_allclose(
                runs["ep"][f][key].float().numpy(),
                tensors[key].float().numpy(), rtol=2e-2, atol=2e-2)
    rc, out = prepare(["--target-model", moe, "--data",
                       str(tmp_path / "data.jsonl"), "--output-dir",
                       str(tmp_path / "over"), "--shard-over-devices", "2",
                       "--moe-impl", "ep", "--moe-capacity-factor",
                       str(OVERFLOWS)])
    assert rc != 0
    assert "EP MoE capacity overflow" in out
    assert not os.path.exists(tmp_path / "over") or not os.listdir(
        tmp_path / "over")


def inline(url, ids, mask):
    body = json.dumps({"input_ids": [int(t) for t in ids],
                       "loss_mask": [int(t) for t in mask],
                       "sample_id": "s0",
                       "spec_capture": {"sink": "inline"}}).encode()
    req = urllib.request.Request(f"{url}/generate", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=RANK_TIMEOUT) as r:
        spec = json.loads(r.read())["meta_info"]["spec_capture"]
    out = {}
    for name, meta in spec["features"].items():
        raw = torch.frombuffer(bytearray(base64.b64decode(spec["data"][name])),
                               dtype=torch.uint8)
        out[name] = raw.view(getattr(torch, meta["dtype"])).reshape(
            meta["shape"])
    return out


def test_two_rank_capture_server(targets, tmp_path):
    """``capture_server_main --shard-over-devices 2``: ready only once both
    ranks loaded, its features those of a one-device engine bit for bit,
    and SIGTERM ends both ranks with exit 0."""
    from specforge_tpu_torch.inference.capture_server import CaptureEngine

    dense, _ = targets
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "specforge_tpu_torch.inference.capture_server_main",
         "--target-model", dense, "--port", str(port), "--capture-layers",
         *map(str, LAYERS), "--max-length", "32", "--shard-over-devices",
         "2", "--device", "cpu"],
        cwd=REPO, env=rank_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + RANK_TIMEOUT
        health = None
        while time.monotonic() < deadline and health is None:
            assert proc.poll() is None, proc.stdout.read()
            try:
                with urllib.request.urlopen(f"{url}/health", timeout=1) as r:
                    health = json.loads(r.read())
            except OSError:
                time.sleep(0.2)
        assert health is not None, "the server never became ready"
        assert health["ranks"] == 2
        rng = np.random.default_rng(3)
        ids = rng.integers(0, V, size=20)
        mask = (rng.random(20) > 0.3).astype(int)
        remote = inline(url, ids, mask)
        local = CaptureEngine(dense, capture_layers=LAYERS, max_length=32,
                              device="cpu").capture(ids, mask)
        assert set(remote) == set(local)
        for name, value in local.items():
            assert torch.equal(remote[name], value), name
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=RANK_TIMEOUT)
        assert proc.returncode == 0, out
        ranks = [json.loads(line) for line in out.splitlines()
                 if line.startswith('{"capture_rank"')]
        assert sorted(r["capture_rank"] for r in ranks) == [0, 1]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
