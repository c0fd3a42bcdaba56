"""The port's reference-format reader, stores, manifest sharding and loader
transform against the JAX package, on the CPU.

Reference ``.ckpt`` / ``.ckpt.gz`` feature files (``torch.save`` dicts) read
bf16 bit for bit, the same bits the JAX reader gives; the in-memory and
shared-dir stores keep ``tests/test_data_plane.py``'s contract (lifecycle,
backpressure, generations, pins and the sweep); the manifest lists
``.ckpt`` files in JAX's order, ``shard_refs`` cuts it as JAX does, and the
loader applies a per-sample ``transform`` with and without workers."""

import gzip
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from specforge_tpu.runtime.data_plane import feature_file as jax_ff
from specforge_tpu.runtime.data_plane.offline_reader import (
    OfflineManifestReader as JaxOfflineManifestReader,
)
from specforge_tpu.runtime.data_plane.offline_reader import (
    shard_refs as jax_shard_refs,
)
from specforge_tpu_torch.data.collator import CollatorConfig, PaddingCollator
from specforge_tpu_torch.runtime.data_plane import feature_file as pt_ff
from specforge_tpu_torch.runtime.data_plane.feature_dataloader import (
    FeatureDataLoader,
)
from specforge_tpu_torch.runtime.data_plane.feature_store import (
    FileFeatureStore,
    InMemoryFeatureStore,
    SharedDirFeatureStore,
    StaleReferenceError,
    StoreError,
)
from specforge_tpu_torch.runtime.data_plane.offline_reader import (
    FEATURE_SUFFIXES,
    OfflineManifestReader,
    shard_refs,
)

H = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per worker: several pytest workers share
    the machine in the tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def reference_sample(gen, seq):
    """One sample as the reference writes it: a dict of CPU tensors, bf16
    hidden states."""
    return {
        "input_ids": torch.randint(0, 100, (seq,), generator=gen),
        "loss_mask": (torch.rand(seq, generator=gen) > 0.3).long(),
        "hidden_state": torch.randn(seq, 3 * H, generator=gen).bfloat16(),
        "target": torch.randn(seq, H, generator=gen).bfloat16(),
    }


def write_ckpt(path, tensors):
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            torch.save(tensors, f)
    else:
        torch.save(tensors, path)


def bits(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


@pytest.mark.parametrize("suffix", [".ckpt", ".ckpt.gz"])
def test_reference_ckpt_reads_bit_exact_like_jax(tmp_path, suffix):
    gen = torch.Generator().manual_seed(0)
    tensors = reference_sample(gen, 12)
    # a value that is not a tensor becomes one, as JAX's np.asarray does
    raw = dict(tensors, lengths=[12, 0])
    path = str(tmp_path / f"s-0000{suffix}")
    write_ckpt(path, raw)
    got, meta = pt_ff.load_feature_file(path)
    ref, ref_meta = jax_ff.load_feature_file(path)
    assert meta == ref_meta == {}
    assert sorted(got) == sorted(ref) == sorted(raw)
    assert got["hidden_state"].dtype == torch.bfloat16
    assert ref["hidden_state"].dtype == np.dtype(ml_dtypes.bfloat16)
    for key, value in tensors.items():
        assert bits(got[key]) == bits(value) == bits(ref[key]), key
        assert tuple(got[key].shape) == ref[key].shape
    np.testing.assert_array_equal(got["lengths"].numpy(), ref["lengths"])


def test_convert_ckpt_to_safetensors_round_trips(tmp_path):
    gen = torch.Generator().manual_seed(1)
    tensors = reference_sample(gen, 9)
    src = str(tmp_path / "a.ckpt.gz")
    dst = str(tmp_path / "a.sft")
    write_ckpt(src, tensors)
    pt_ff.convert_ckpt_to_safetensors(src, dst, {"target_repr": "hidden_state"})
    got, meta = pt_ff.load_feature_file(dst)
    ref, ref_meta = jax_ff.load_feature_file(dst)
    assert meta == ref_meta == {"target_repr": "hidden_state"}
    for key, value in tensors.items():
        assert bits(got[key]) == bits(value) == bits(ref[key]), key
    # JAX's converter writes the same file
    jax_dst = str(tmp_path / "b.sft")
    jax_ff.convert_ckpt_to_safetensors(src, jax_dst,
                                       {"target_repr": "hidden_state"})
    jax_got, _ = pt_ff.load_feature_file(jax_dst)
    for key in tensors:
        assert bits(jax_got[key]) == bits(got[key]), key


def write_mixed_dataset(root, n=7):
    """``.sft``, ``.ckpt`` and ``.ckpt.gz`` files in nested directories,
    plus files the reader must skip."""
    gen = torch.Generator().manual_seed(2)
    suffixes = (".sft", ".ckpt", ".ckpt.gz")
    for i in range(n):
        sub = os.path.join(root, f"part{i % 2}")
        os.makedirs(sub, exist_ok=True)
        suffix = suffixes[i % 3]
        path = os.path.join(sub, f"sample-{i:04d}{suffix}")
        tensors = reference_sample(gen, 10 + i)
        if suffix == ".sft":
            pt_ff.save_feature_file(path, tensors,
                                    {"target_repr": "hidden_state"})
        else:
            write_ckpt(path, tensors)
    open(os.path.join(root, "notes.txt"), "w").close()
    open(os.path.join(root, "part0", "x.ckpt.tmp"), "w").close()


def test_manifest_lists_ckpt_files_in_jax_order(tmp_path):
    write_mixed_dataset(str(tmp_path))
    assert FEATURE_SUFFIXES == (".sft", ".ckpt", ".ckpt.gz")
    reader = OfflineManifestReader(str(tmp_path))
    jax_reader = JaxOfflineManifestReader(str(tmp_path))
    assert reader.list_files() == jax_reader.list_files()
    assert len(reader.list_files()) == 7
    refs, jax_refs = reader.read(epoch=2), jax_reader.read(epoch=2)
    assert [r.to_json() for r in refs] == [r.to_json() for r in jax_refs]
    only_sft = OfflineManifestReader(str(tmp_path), suffixes=(".sft",))
    assert only_sft.list_files() == JaxOfflineManifestReader(
        str(tmp_path), suffixes=(".sft",)).list_files()
    # every file fetches through the file store, bf16 as the JAX store reads
    store = FileFeatureStore()
    for ref in refs:
        tensors = store.fetch(ref)
        ref_tensors, _ = jax_ff.load_feature_file(
            ref.features["__file__"].uri[len("file://"):])
        for key, value in ref_tensors.items():
            assert bits(tensors[key]) == bits(value), (ref.sample_id, key)
    assert store.health() == {"backend": "file", "fetches": 7}
    with pytest.raises(StoreError, match="read-only"):
        store.put_sample("x", {})


@pytest.mark.parametrize("n,world,drop", [(7, 2, True), (7, 2, False),
                                          (9, 4, True), (3, 4, True),
                                          (5, 1, True)])
def test_shard_refs_matches_jax(tmp_path, n, world, drop):
    write_mixed_dataset(str(tmp_path), n=n)
    refs = OfflineManifestReader(str(tmp_path)).read()
    jax_refs = JaxOfflineManifestReader(str(tmp_path)).read()
    for rank in range(world):
        got = shard_refs(refs, rank, world, drop_remainder=drop)
        ref = jax_shard_refs(jax_refs, rank, world, drop_remainder=drop)
        assert [r.sample_id for r in got] == [r.sample_id for r in ref]
    if drop:
        sizes = {len(shard_refs(refs, r, world)) for r in range(world)}
        assert sizes == {n // world}


def test_memory_store_lifecycle():
    store = InMemoryFeatureStore(max_resident_bytes=10_000)
    gen = torch.Generator().manual_seed(0)
    tensors = reference_sample(gen, 8)
    ref = store.put_sample("s0", tensors)
    assert {name: h.spec.dtype for name, h in ref.features.items()} == {
        "input_ids": "int64", "loss_mask": "int64",
        "hidden_state": "bfloat16", "target": "bfloat16"}
    out = store.fetch(ref)
    assert set(out) == {"input_ids", "loss_mask", "hidden_state", "target"}
    out["target"].zero_()  # fetches are clones
    assert bits(store.fetch(ref)["target"]) == bits(tensors["target"])
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    health = store.health()
    assert health["resident_samples"] == 1
    assert health["resident_bytes"] == nbytes
    assert health["fetches"] == 2 and health["puts"] == 1
    store.put_sample("s0", tensors)  # a re-put is a no-op
    assert store.health()["resident_bytes"] == nbytes
    store.release(["s0"])
    assert store.health()["resident_samples"] == 0
    with pytest.raises(KeyError):
        store.fetch(ref)
    store.put_sample("d", {"x": torch.ones(3)})
    store.abort("d")
    assert store.health()["resident_samples"] == 0


def test_memory_store_backpressure_and_generation():
    store = InMemoryFeatureStore(max_resident_bytes=300)
    store.put_sample("a", {"x": torch.zeros(50, dtype=torch.float32)})
    with pytest.raises(MemoryError):
        store.put_sample("b", {"x": torch.zeros(50, dtype=torch.float32)})
    ref = store.put_sample("c", {"x": torch.zeros(2, dtype=torch.float32)})
    assert store.fetch(ref)["x"].shape == (2,)
    store.generation += 1  # producer restart
    with pytest.raises(StaleReferenceError):
        store.fetch(ref)
    assert issubclass(StaleReferenceError, StoreError)


def test_memory_store_pin_and_gc_sweep():
    store = InMemoryFeatureStore()
    kept = store.put_sample("keep", {"x": torch.ones(4)})
    store.put_sample("leak", {"x": torch.zeros(4)})
    store.pin(["keep"])
    assert store.gc_sweep(0.0) == 1
    assert store.fetch(kept)["x"].sum() == 4.0
    assert store.health()["resident_samples"] == 1
    assert store.gc_sweep(3600.0) == 0
    store.unpin(["keep"])
    assert store.gc_sweep(0.0) == 1


def test_memory_store_accounting_under_threads():
    """Puts, fetches and releases from more threads than cores, with the
    interpreter switching threads often: the resident bytes stay the sum
    over the resident samples, and every fetch of a resident sample gets
    its own bytes."""
    import sys
    import threading

    store = InMemoryFeatureStore(max_resident_bytes=1 << 30)
    errors = []

    def worker(w):
        try:
            for i in range(150):
                sid = f"w{w}-{i % 7}"
                value = torch.full((8 + i % 5,), float(w))
                ref = store.put_sample(sid, {"x": value})
                try:
                    got = store.fetch(ref)["x"]
                    assert bool((got == w).all())
                except KeyError:  # another round of this worker released it
                    pass
                if i % 3 == 0:
                    store.release([sid])
                store.gc_sweep(3600.0)
        except Exception as e:  # reported below, with the worker
            errors.append((w, repr(e)))

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(4 * (os.cpu_count() or 1) + 1)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(before)
    assert errors == []
    with store._lock:
        resident = sum(store._bytes.values())
        assert set(store._bytes) == set(store._data)
    health = store.health()
    assert health["resident_bytes"] == resident
    assert health["resident_samples"] == len(store._bytes)
    assert health["puts"] - health["releases"] == health["resident_samples"]


def test_shared_dir_store(tmp_path):
    root = tmp_path / "plane"
    store = SharedDirFeatureStore(str(root), generation=3)
    gen = torch.Generator().manual_seed(0)
    tensors = reference_sample(gen, 9)
    ref = store.put_sample("s1", tensors, {"target_repr": "x"})
    assert os.listdir(root) == ["s1.g3.sft"]
    out = store.fetch(ref)
    assert tuple(out["hidden_state"].shape) == (9, 3 * H)
    for key, value in tensors.items():
        assert bits(out[key]) == bits(value), key
    # the JAX package reads the published file the same way
    jax_tensors, meta = jax_ff.load_feature_file(str(root / "s1.g3.sft"))
    assert meta == {"target_repr": "x"}
    assert bits(jax_tensors["hidden_state"]) == bits(tensors["hidden_state"])
    # a consumer of the next generation still finds the ref's own file
    assert SharedDirFeatureStore(str(root), generation=4).fetch(ref)
    assert store.health()["resident_samples"] == 1
    store.release(["s1", "missing"])
    assert store.health()["releases"] == 1
    with pytest.raises(StaleReferenceError):
        store.fetch(ref)


@pytest.mark.parametrize("num_workers", [0, 3])
def test_loader_transform(tmp_path, num_workers):
    """``transform(tensors, ref)`` runs on every fetched sample, before
    collation, with the batches in manifest order."""
    write_mixed_dataset(str(tmp_path), n=6)
    refs = OfflineManifestReader(str(tmp_path)).read()
    seen = []

    def transform(tensors, ref):
        seen.append(ref.sample_id)
        out = dict(tensors)
        out["input_ids"] = tensors["input_ids"] + 1000
        out["position_ids"] = torch.arange(tensors["input_ids"].shape[0]) + 5
        return out

    collate = PaddingCollator(CollatorConfig(max_length=16))
    loader = FeatureDataLoader(FileFeatureStore(), collate, refs=refs,
                               batch_size=2, transform=transform,
                               num_workers=num_workers)
    plain = FeatureDataLoader(FileFeatureStore(), collate, refs=refs,
                              batch_size=2, num_workers=0)
    batches, plain_batches = list(loader), list(plain)
    assert len(batches) == 3
    assert sorted(seen) == sorted(r.sample_id for r in refs)
    for batch, ref in zip(batches, plain_batches):
        assert batch.sample_ids == ref.sample_ids
        real = ref.tensors["attention_mask"].bool()
        np.testing.assert_array_equal(
            batch.tensors["input_ids"][real].numpy(),
            ref.tensors["input_ids"][real].numpy() + 1000)
        assert batch.tensors["position_ids"][0, 0] == 5
        assert "position_ids" not in ref.tensors
