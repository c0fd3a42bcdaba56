"""The port's capture server against the JAX package's, on the CPU.

Both servers hold one tiny target (written by ``transformers``), loaded in
fp32 on each side, and get the same ``/generate_batch`` request: the same
bucket shapes, the same response structure (keys, shapes, dtype names) and
the same features, within ``tests/test_torch_capture.py``'s ``TOL`` for the
fp32 forwards plus one bf16 step (``BF16_STEP``, 2^-7 relative) for each
side's cast to bf16, which can round values that straddle a bf16 boundary
to neighbours. Then the adapters across servers, both layouts, the
coalescer and the refusals."""

import base64
import json
import threading
import urllib.request

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from specforge_tpu.inference import capture_server as jax_cs
from specforge_tpu.inference.server_capture_adapter import (
    HTTPCaptureAdapter as JaxAdapter,
)
from specforge_tpu.models.target import transformer as jax_tf
from specforge_tpu.runtime.contracts import PromptTask as JaxPromptTask
from specforge_tpu.runtime.data_plane.feature_store import (
    InMemoryFeatureStore as JaxMemoryStore,
)
from specforge_tpu_torch.inference import capture_server as pt_cs
from specforge_tpu_torch.inference import capture_server_main
from specforge_tpu_torch.inference.server_capture_adapter import (
    HTTPCaptureAdapter,
)
from specforge_tpu_torch.models.target import transformer as pt_tf
from specforge_tpu_torch.runtime.contracts import PromptTask
from specforge_tpu_torch.runtime.data_plane.feature_store import (
    InMemoryFeatureStore,
)
from tests.test_torch_capture import TOL, save_target

V, H, MAXLEN = 128, 32, 32
LAYERS = (1, 2, 2)
#: one bf16 step, relative: two fp32 values within TOL may round to
#: neighbouring bf16 values
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per test worker (see test_torch_train.py's
    fixture of the same name: the default oversubscribes a shared CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    return save_target(tmp_path_factory.mktemp("target"), "llama")


def engines(target, layout):
    jcfg = jax_tf.TargetConfig.from_file(target)
    pcfg = pt_tf.TargetConfig.from_file(target)
    jax_engine = jax_cs.CaptureEngine(
        target, capture_layers=LAYERS, layout=layout, max_length=MAXLEN,
        target_config=jcfg,
        target_params=jax_tf.load_target_params(target, jcfg,
                                                dtype=jnp.float32))
    engine = pt_cs.CaptureEngine(
        target, capture_layers=LAYERS, layout=layout, max_length=MAXLEN,
        target_config=pcfg,
        target_params=pt_tf.load_target_params(target, pcfg,
                                               dtype=torch.float32,
                                               device="cpu"))
    return jax_engine, engine


@pytest.fixture(scope="module", params=["eagle", "dflash"])
def servers(request, target):
    jax_engine, engine = engines(target, request.param)
    jax_server = jax_cs.CaptureServer(jax_engine).start()
    server = pt_cs.CaptureServer(engine).start()
    yield request.param, jax_server, server
    jax_server.stop()
    server.stop()


def prompts(n=5, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(10, MAXLEN + 6))  # some over max_length
        out.append({
            "input_ids": rng.integers(0, V, size=length).tolist(),
            "loss_mask": (rng.random(length) > 0.3).astype(int).tolist(),
            "sample_id": f"p{i:03d}",
        })
    if n > 1:
        out[1]["loss_mask"] = None  # the key present but null: all ones
    return out


def post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def decode(spec):
    dtypes = {"bfloat16": ml_dtypes.bfloat16, "int64": np.int64}
    return {name: np.frombuffer(base64.b64decode(spec["data"][name]),
                                dtype=dtypes[m["dtype"]]).reshape(m["shape"])
            for name, m in spec["features"].items()}


def structure(obj):
    """Keys and value types, recursively; data blobs by name only."""
    if isinstance(obj, dict):
        return {k: (sorted(v) if k == "data" else structure(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [structure(v) for v in obj]
    return type(obj).__name__


def assert_features_close(got, ref):
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        assert got[name].dtype == ref[name].dtype, name
        if ref[name].dtype == np.int64:
            np.testing.assert_array_equal(got[name], ref[name])
        else:
            np.testing.assert_allclose(
                got[name].astype(np.float32), ref[name].astype(np.float32),
                rtol=TOL + BF16_STEP, atol=TOL, err_msg=name)


def test_generate_batch_matches_jax(servers):
    layout, jax_server, server = servers
    body = {"samples": prompts(), "spec_capture": {"sink": "inline"}}
    ref = post(jax_server.port, "/generate_batch", body)
    got = post(server.port, "/generate_batch", body)
    assert structure(got) == structure(ref)
    aux = "hidden_state" if layout == "eagle" else "hidden_states"
    for g, r, p in zip(got["results"], ref["results"], body["samples"]):
        gs, rs = g["meta_info"]["spec_capture"], r["meta_info"][
            "spec_capture"]
        assert gs["features"] == rs["features"]
        assert gs["sample_id"] == rs["sample_id"] == p["sample_id"]
        n = min(len(p["input_ids"]), MAXLEN)
        assert gs["features"][aux]["shape"] == [n, len(LAYERS) * H]
        assert_features_close(decode(gs), decode(rs))


def test_generate_single_matches_jax(servers):
    layout, jax_server, server = servers
    body = {**prompts(1, seed=3)[0], "spec_capture": {"sink": "inline"}}
    got = post(server.port, "/generate", body)
    ref = post(jax_server.port, "/generate", body)
    assert structure(got) == structure(ref)
    assert_features_close(decode(got["meta_info"]["spec_capture"]),
                          decode(ref["meta_info"]["spec_capture"]))


def test_health_reports_the_device(servers):
    layout, _jax_server, server = servers
    with urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/health") as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok" and health["layout"] == layout
    assert health["device"] == "cpu" and "coalesce" in health
    with pytest.raises(urllib.error.HTTPError):
        post(server.port, "/generate_batch", {
            "samples": prompts(1), "spec_capture": {"sink": "nowhere"}})


@pytest.mark.parametrize("args", [
    (1, 1400, 1500), (1, 100, 1500), (32, 10, 2048), (17, 10, 2048),
    (2, 9999, 2048), (3, 129, 4096), (16, 8192, 8192), (5, 1, 128),
    (9, 300, 700),
])
def test_resolve_batch_shape_matches_jax(args):
    sb, bb = pt_cs.CaptureEngine.SEQ_BUCKETS, pt_cs.CaptureEngine.BATCH_BUCKETS
    assert (sb, bb) == (jax_cs.CaptureEngine.SEQ_BUCKETS,
                        jax_cs.CaptureEngine.BATCH_BUCKETS)
    got = pt_cs.resolve_batch_shape(*args, sb, bb)
    assert got == jax_cs.resolve_batch_shape(*args, sb, bb)
    n, longest, max_length = args
    assert got[0] >= n and got[1] >= min(longest, max_length)


def tasks(cls, n=4, seed=7):
    return [cls(prompt_id=p["sample_id"],
                payload={"input_ids": p["input_ids"],
                         "loss_mask": p["loss_mask"]})
            for p in prompts(n, seed)]


def test_adapters_across_servers_inline(servers):
    """JAX's adapter against the port's server makes the same refs (and
    features) as the port's adapter against JAX's server."""
    layout, jax_server, server = servers
    jax_store, store = JaxMemoryStore(), InMemoryFeatureStore()
    jax_refs = JaxAdapter(f"http://127.0.0.1:{server.port}",
                          store=jax_store).produce_refs_batch(
        tasks(JaxPromptTask))
    refs = HTTPCaptureAdapter(f"http://127.0.0.1:{jax_server.port}",
                              store=store).produce_refs_batch(
        tasks(PromptTask))
    assert [r.to_json() for r in refs] == [r.to_json() for r in jax_refs]
    single = HTTPCaptureAdapter(f"http://127.0.0.1:{jax_server.port}",
                                store=store).produce_refs(
        tasks(PromptTask, 1, seed=9)[0])
    assert single[0].prompt_id == tasks(PromptTask, 1, seed=9)[0].prompt_id
    for jr, r in zip(jax_refs, refs):
        got = {k: v.contiguous().view(torch.uint8).numpy().view(
            ml_dtypes.bfloat16 if v.dtype == torch.bfloat16 else np.int64
        ).reshape(v.shape) for k, v in store.fetch(r).items()}
        assert_features_close(got, {k: np.asarray(v) for k, v in
                                    jax_store.fetch(jr).items()})


def test_coalescer_merges_concurrent_requests(target):
    """Concurrent single /generate requests run as far fewer forwards, and
    a coalesced sample agrees with its capture alone."""
    _jax_engine, engine = engines(target, "eagle")
    server = pt_cs.CaptureServer(engine, coalesce_window_ms=25.0).start()
    try:
        bodies = [{**p, "loss_mask": [1] * len(p["input_ids"]),
                   "spec_capture": {"sink": "inline"}}
                  for p in prompts(12, seed=11)]
        results = [None] * len(bodies)

        def fire(i):
            results[i] = post(server.port, "/generate", bodies[i])

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert server.coalescer.requests_served == len(bodies)
        assert server.coalescer.batches_run <= len(bodies) // 2
        for i, res in enumerate(results):
            spec = res["meta_info"]["spec_capture"]
            assert spec["sample_id"] == bodies[i]["sample_id"]
            assert spec["features"]["hidden_state"]["shape"] == [
                min(len(bodies[i]["input_ids"]), MAXLEN), 3 * H]
        solo = engine.capture(np.asarray(bodies[0]["input_ids"]),
                              np.asarray(bodies[0]["loss_mask"]))
        # fp32 forwards at another padded shape, each cast to bf16
        np.testing.assert_allclose(
            decode(results[0]["meta_info"]["spec_capture"])[
                "hidden_state"].astype(np.float32),
            solo["hidden_state"].float().numpy(),
            rtol=TOL + BF16_STEP, atol=TOL)
    finally:
        server.stop()


def test_capture_server_main_refuses_the_mesh_and_ep(target, monkeypatch):
    """JAX's refusals: EP without a mesh (``--moe-impl ep`` alone), EP on a
    dense target, more ranks than cards (``build_capture_mesh``'s
    message). A capacity factor without EP is taken, as JAX's engine takes
    it, and a one-rank mesh serves as one device does."""
    from specforge_tpu_torch.offline_capture.capture import (
        build_capture_mesh,
    )
    from specforge_tpu_torch.parallel.multihost import resolve_rank_count

    base = ["--target-model", target, "--port", "0", "--capture-layers",
            "1", "--device", "cpu"]
    with pytest.raises(ValueError, match="requires a device mesh"):
        capture_server_main.main([*base, "--moe-impl", "ep"])
    with pytest.raises(ValueError, match="needs an MoE target"):
        capture_server_main.main([*base, "--moe-impl", "ep",
                                  "--shard-over-devices", "0"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 capture devices, "
                                         "have 1"):
        resolve_rank_count(2, torch.device("cuda"))
    assert resolve_rank_count(0, torch.device("cuda")) == 1
    engine = pt_cs.CaptureEngine(target, LAYERS, moe_capacity_factor=1.0,
                                 device="cpu")
    meshed = pt_cs.CaptureEngine(target, LAYERS, device="cpu",
                                 mesh=build_capture_mesh(1, "cpu"))
    ids = np.arange(1, 12)
    mask = np.ones_like(ids)
    one, two = engine.capture(ids, mask), meshed.capture(ids, mask)
    assert all(torch.equal(one[k], two[k]) for k in one)


def test_capture_server_main_needs_cuda(target, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        capture_server_main.main(["--target-model", target, "--port", "0",
                                  "--capture-layers", "1"])


def test_adapters_across_servers_store_sink(servers):
    """The store sink: each server writes into the port-built store itself
    and each package's adapter adopts the objects the other's server
    wrote; the refs are the same and the objects' bytes agree as the
    inline features do."""
    from specforge_tpu.runtime.data_plane.network_store import (
        NetworkFeatureStore as JaxNetworkFeatureStore,
    )
    from specforge_tpu_torch.runtime.data_plane.network_store import (
        NetworkFeatureStore,
    )
    from tests._torch_online import start_store

    layout, jax_server, server = servers
    proc, endpoint = start_store()
    try:
        jax_store = JaxNetworkFeatureStore(endpoint, generation=1)
        store = NetworkFeatureStore(endpoint, generation=2)
        jax_refs = JaxAdapter(f"http://127.0.0.1:{server.port}",
                              store=jax_store, store_endpoint=endpoint,
                              generation=1).produce_refs_batch(
            tasks(JaxPromptTask))
        refs = HTTPCaptureAdapter(f"http://127.0.0.1:{jax_server.port}",
                                  store=store, store_endpoint=endpoint,
                                  generation=2).produce_refs_batch(
            tasks(PromptTask))
        strip = [{**r.to_json(), "features": {
            k: {**v, "uri": v["uri"].replace(".g1", ".g").replace(
                ".g2", ".g")} for k, v in r.to_json()["features"].items()}}
            for r in jax_refs]
        assert strip == [{**r.to_json(), "features": {
            k: {**v, "uri": v["uri"].replace(".g2", ".g")}
            for k, v in r.to_json()["features"].items()}} for r in refs]
        assert store.health()["pinned"] == 2 * 4 * len(refs)  # adopted
        for jr, r in zip(jax_refs, refs):
            got = {k: v.contiguous().view(torch.uint8).numpy().view(
                ml_dtypes.bfloat16 if v.dtype == torch.bfloat16
                else np.int64).reshape(v.shape)
                for k, v in NetworkFeatureStore(endpoint).fetch(
                    type(r).from_json(jr.to_json())).items()}
            assert_features_close(got, {k: np.asarray(v) for k, v in
                                        jax_store.fetch(r).items()})
        jax_store.release_refs(jax_refs)
        store.release_refs(refs)
        assert store.health()["objects"] == 0
    finally:
        proc.terminate()
        proc.wait(timeout=10)
