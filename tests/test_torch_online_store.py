"""The port's network feature store client against the C++ server the
port builds (``network_store.server_binary``: ``g++`` from
``cpp/feature_store_server.cpp`` into ``specforge_tpu_torch/_build/``),
through the cases of ``tests/test_network_store.py``, one fault of
``tests/test_network_store_faults.py``, and objects that cross between the
two packages' clients bit for bit, both ways. Skipped without ``g++``, as
the JAX package's store tests are."""

import queue
import shutil
import socket
import struct
import subprocess
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from specforge_tpu.runtime.data_plane.network_store import (
    NetworkFeatureStore as JaxNetworkFeatureStore,
)
from specforge_tpu_torch.data.collator import CollatorConfig, PaddingCollator
from specforge_tpu_torch.runtime.contracts import FeatureSpec
from specforge_tpu_torch.runtime.data_plane.feature_dataloader import (
    FeatureDataLoader,
)
from specforge_tpu_torch.runtime.data_plane.feature_store import (
    StaleReferenceError,
)
from specforge_tpu_torch.runtime.data_plane.network_store import (
    AuthError,
    NetworkFeatureStore,
    server_binary,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per test worker (see test_torch_train.py's
    fixture of the same name: the default oversubscribes a shared CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(*args):
    """The port's server on a free port → (process, port)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")
    port = free_port()
    proc = subprocess.Popen([str(server_binary()), "--port", str(port),
                             *args],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    for _ in range(200):
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            return proc, port
        except OSError:
            time.sleep(0.05)
    proc.kill()
    pytest.fail("feature_store_server did not start")


@pytest.fixture(scope="module")
def server():
    proc, port = spawn("--max-bytes", str(64 * 1024 * 1024))
    yield port
    proc.terminate()
    proc.wait(timeout=5)


def tensors(seed, seq=16, h=8):
    gen = torch.Generator().manual_seed(seed)
    return {
        "input_ids": torch.randint(0, 100, (seq,), generator=gen),
        "hidden_state": torch.randn(seq, 3 * h, generator=gen).to(
            torch.bfloat16),
        "target": torch.randn(seq, h, generator=gen).to(torch.bfloat16),
    }


def test_server_binary_is_built_once_into_the_build_dir():
    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")
    path = server_binary()
    assert path.parent.name == "_build" and path.exists()
    assert server_binary() == path  # the digest names the source's build


def test_put_fetch_release_roundtrip(server):
    store = NetworkFeatureStore(f"127.0.0.1:{server}", generation=1)
    t = tensors(0)
    ref = store.put_sample("s0", t, {"target_repr": "hidden_state"})
    assert ref.features["hidden_state"].spec.dtype == "bfloat16"
    assert ref.features["input_ids"].spec.dtype == "int64"
    out = store.fetch(ref)
    for name in t:
        assert out[name].dtype == t[name].dtype
        assert torch.equal(out[name], t[name])
    assert store.fetched_bytes == ref.nbytes
    health = store.health()
    assert health["objects"] >= 3 and health["backend"] == "network"
    store.release_refs([ref])
    with pytest.raises(StaleReferenceError):
        store.fetch(ref)


def test_generation_staleness(server):
    store = NetworkFeatureStore(f"127.0.0.1:{server}", generation=2)
    ref = store.put_sample("gen", tensors(1))
    # a restarted producer writes generation 3; old refs keep their keys
    store2 = NetworkFeatureStore(f"127.0.0.1:{server}", generation=3)
    fresh = store2.put_sample("gen", tensors(1))
    assert fresh.features["target"].uri != ref.features["target"].uri
    assert store2.fetch(ref)  # resolvable until released
    store.release_refs([ref])
    with pytest.raises(StaleReferenceError):
        store.fetch(ref)
    store2.release_refs([fresh])


def test_over_budget_put_raises(server):
    store = NetworkFeatureStore(f"127.0.0.1:{server}")
    with pytest.raises(MemoryError):
        store.put_sample("huge", {"x": torch.zeros(80 * 1024 * 1024 // 4)})


def test_adopt_builds_refs(server):
    writer = NetworkFeatureStore(f"127.0.0.1:{server}", generation=4)
    t = tensors(2)
    writer.put_sample("adopted", t)  # a capture server's own write
    store = NetworkFeatureStore(f"127.0.0.1:{server}", generation=4)
    ref = store.adopt("adopted", {
        name: FeatureSpec(name=name, shape=tuple(x.shape),
                          dtype=str(x.dtype).removeprefix("torch."))
        for name, x in t.items()})
    assert store.health()["pinned"] >= 3  # adoption pins
    assert torch.equal(store.fetch(ref)["hidden_state"], t["hidden_state"])
    store.release_refs([ref])  # the lifetime authority unpins and deletes
    with pytest.raises(StaleReferenceError):
        store.fetch(ref)


def test_loader_through_network_store(server):
    store = NetworkFeatureStore(f"127.0.0.1:{server}", generation=5)
    q = queue.Queue()
    refs = [store.put_sample(f"n{i}", tensors(10 + i)) for i in range(5)]
    for r in refs:
        q.put(r)
    q.put(None)
    loader = FeatureDataLoader(
        store, PaddingCollator(CollatorConfig(max_length=20)), ref_queue=q,
        batch_size=2, num_workers=2)
    assert not loader.supports_seek
    with pytest.raises(TypeError):
        len(loader)
    batches = list(loader)
    assert len(batches) == 2  # the fifth sample: an incomplete batch
    assert batches[0].tensors["hidden_state"].shape == (2, 20, 24)
    assert batches[1].sample_ids == ["n2", "n3"]
    store.release_refs(refs)
    with pytest.raises(ValueError, match="exactly one"):
        FeatureDataLoader(store, None, refs=[], ref_queue=q)


def test_auth_required_and_enforced():
    proc, port = spawn("--secret", "hunter2")
    try:
        t = {"x": torch.arange(8, dtype=torch.float32)}
        with pytest.raises(AuthError):
            NetworkFeatureStore(f"127.0.0.1:{port}",
                                secret="wrong").put_sample("s", t)
        with pytest.raises(Exception):
            NetworkFeatureStore(f"127.0.0.1:{port}",
                                secret="").put_sample("s", t)
        store = NetworkFeatureStore(f"127.0.0.1:{port}", secret="hunter2")
        ref = store.put_sample("s", t)
        assert torch.equal(store.fetch(ref)["x"], t["x"])
    finally:
        proc.terminate()
        proc.wait(timeout=5)


def test_pins_gc_sweep_and_pending_removals():
    proc, port = spawn()
    try:
        store = NetworkFeatureStore(f"127.0.0.1:{port}", generation=7)
        ref = store.put_sample("pinme", {"x": torch.ones(16)})
        leaked = store.put_sample("leak", {"x": torch.zeros(16)})
        store.pin_refs([ref])
        assert store.gc_sweep(0) == 1  # the unpinned leak
        assert float(store.fetch(ref)["x"].sum()) == 16.0
        with pytest.raises(StaleReferenceError):
            store.fetch(leaked)
        store.pin_refs([ref])  # a second pin: release unpins until it goes
        store.release_refs([ref])
        health = store.health()
        assert health["objects"] == 0 and health["pinned"] == 0
        store._pending_removals.append("gone/x.g7")
        assert store.drain_pending_removals() == 1
        with pytest.raises(Exception, match="release_refs"):
            store.release(["pinme"])
    finally:
        proc.terminate()
        proc.wait(timeout=5)


def test_fetch_into_preallocated(server):
    store = NetworkFeatureStore(f"127.0.0.1:{server}", generation=9)
    a = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    b = (torch.arange(256).reshape(16, 16) % 7).to(torch.bfloat16)
    ref = store.put_sample("zc", {"a": a, "b": b})
    out_a, out_b = torch.empty(64, 64), torch.empty(16, 16,
                                                    dtype=torch.bfloat16)
    store.fetch_feature_into(ref.features["a"], out_a)
    store.fetch_feature_into(ref.features["b"], out_b)
    assert torch.equal(out_a, a) and torch.equal(out_b, b)
    with pytest.raises(Exception, match="size"):
        store.fetch_feature_into(ref.features["a"], torch.empty(3))
    store.release_refs([ref])


def test_truncated_frame_dropped_server_stays_healthy():
    """A peer that sends half a frame and stalls is dropped by the frame
    timeout; a healthy client keeps working throughout."""
    proc, port = spawn("--max-bytes", str(256 * 1024 * 1024),
                       "--frame-timeout-seconds", "1",
                       "--max-connections", "4")
    try:
        bad = socket.create_connection(("127.0.0.1", port))
        # op 'P' and a key length of 16 bytes, then 3 of them and a stall
        bad.sendall(b"P" + struct.pack("<I", 16) + b"abc")
        store = NetworkFeatureStore(f"127.0.0.1:{port}")
        ref = store.put_sample("s1", tensors(3))
        assert store.fetch(ref)["input_ids"].shape == (16,)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if store.health().get("timeouts", 0) >= 1:
                break
            time.sleep(0.2)
        health = store.health()
        bad.close()
        assert health["timeouts"] >= 1, health
        assert torch.equal(store.fetch(ref)["target"], tensors(3)["target"])
        store.close()
    finally:
        proc.terminate()
        proc.wait(timeout=5)


# --------------------------------------------------------------------------
# objects across the two packages' clients
# --------------------------------------------------------------------------

def raw(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_port_puts_jax_fetches_bit_identical(server):
    port_store = NetworkFeatureStore(f"127.0.0.1:{server}", generation=11)
    t = tensors(4)
    ref = port_store.put_sample("cross-a", t)
    from specforge_tpu.runtime.contracts import SampleRef as JaxSampleRef

    jax_store = JaxNetworkFeatureStore(f"127.0.0.1:{server}", generation=11)
    got = jax_store.fetch(JaxSampleRef.from_json(ref.to_json()))
    assert got["hidden_state"].dtype == ml_dtypes.bfloat16
    for name, x in t.items():
        assert got[name].shape == tuple(x.shape)
        assert got[name].tobytes() == raw(x), name
    jax_store.release_refs([JaxSampleRef.from_json(ref.to_json())])
    with pytest.raises(StaleReferenceError):
        port_store.fetch(ref)


def test_jax_puts_port_fetches_bit_identical(server):
    rng = np.random.default_rng(5)
    arrays = {
        "input_ids": rng.integers(0, 100, size=(16,)).astype(np.int64),
        "hidden_state": rng.normal(size=(16, 24)).astype(ml_dtypes.bfloat16),
        "loss_mask": np.ones(16, np.int32),
        "x": rng.normal(size=(4, 4)).astype(np.float32),
    }
    jax_store = JaxNetworkFeatureStore(f"127.0.0.1:{server}", generation=12)
    jax_ref = jax_store.put_sample("cross-b", arrays)
    from specforge_tpu_torch.runtime.contracts import SampleRef

    ref = SampleRef.from_json(jax_ref.to_json())
    store = NetworkFeatureStore(f"127.0.0.1:{server}", generation=12)
    got = store.fetch(ref)
    assert got["hidden_state"].dtype == torch.bfloat16
    assert got["loss_mask"].dtype == torch.int32
    for name, a in arrays.items():
        assert tuple(got[name].shape) == a.shape
        assert raw(got[name]) == a.tobytes(), name
    store.release_refs([ref])
    with pytest.raises(StaleReferenceError):
        store.fetch(ref)
