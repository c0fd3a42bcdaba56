"""The PyTorch port's data plane against the JAX package, on the CPU.

``.sft`` feature files cross between the two packages byte for byte (bf16
included), and the port's manifest reader, loader and PaddingCollator give
the batches the JAX ones give."""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from specforge_tpu.data.collator import CollatorConfig as JaxCollatorConfig
from specforge_tpu.data.collator import PaddingCollator as JaxPaddingCollator
from specforge_tpu.runtime.data_plane import feature_file as jax_ff
from specforge_tpu.runtime.data_plane.feature_dataloader import (
    FeatureDataLoader as JaxFeatureDataLoader,
)
from specforge_tpu.runtime.data_plane.feature_store import (
    FileFeatureStore as JaxFileFeatureStore,
)
from specforge_tpu.runtime.data_plane.offline_reader import (
    OfflineManifestReader as JaxOfflineManifestReader,
)
from specforge_tpu.training import vocab_mapping as jax_vocab
from specforge_tpu_torch.data.collator import CollatorConfig, PaddingCollator
from specforge_tpu_torch.runtime import contracts
from specforge_tpu_torch.runtime.data_plane import feature_file as pt_ff
from specforge_tpu_torch.runtime.data_plane.feature_dataloader import (
    FeatureDataLoader,
)
from specforge_tpu_torch.runtime.data_plane.feature_store import (
    FileFeatureStore,
    StoreError,
)
from specforge_tpu_torch.runtime.data_plane.offline_reader import (
    OfflineManifestReader,
)
from specforge_tpu_torch.training import vocab_mapping as pt_vocab

MAXLEN, HID = 32, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per test worker (see test_torch_train.py's
    fixture of the same name: the default oversubscribes a shared CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def sample_arrays(rng, seq):
    """One sample in every dtype the feature files carry."""
    return {
        "input_ids": rng.integers(0, 1000, size=(seq,)).astype(np.int64),
        "loss_mask": (rng.random(seq) > 0.25).astype(np.int64),
        "hidden_state": rng.normal(size=(seq, 3 * HID)).astype(
            ml_dtypes.bfloat16),
        "target": rng.normal(size=(seq, HID)).astype(ml_dtypes.bfloat16),
        "scores": rng.normal(size=(seq, 3)).astype(np.float32),
        "flags": rng.random(seq) > 0.5,
        "small": rng.integers(-5, 5, size=(seq,)).astype(np.int8),
    }


def raw_bytes(x):
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def write_dataset(root, n=6, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        jax_ff.save_feature_file(
            os.path.join(root, f"sample-{i:04d}.sft"),
            sample_arrays(rng, int(rng.integers(10, MAXLEN + 8))),
            {"target_repr": "hidden_state"},
        )


def test_port_reads_jax_feature_files_byte_for_byte(tmp_path):
    rng = np.random.default_rng(1)
    arrays = sample_arrays(rng, 12)
    path = str(tmp_path / "a.sft")
    jax_ff.save_feature_file(path, arrays, {"target_repr": "hidden_state"})
    tensors, meta = pt_ff.load_feature_file(path)
    assert meta == {"target_repr": "hidden_state"}
    assert sorted(tensors) == sorted(arrays)
    assert tensors["hidden_state"].dtype == torch.bfloat16
    for name, arr in arrays.items():
        assert tuple(tensors[name].shape) == arr.shape, name
        assert raw_bytes(tensors[name]) == raw_bytes(arr), name
    specs, meta2 = pt_ff.read_feature_specs(path)
    jax_specs, _ = jax_ff.read_feature_specs(path)
    assert meta2 == meta
    assert {k: s.to_json() for k, s in specs.items()} == {
        k: s.to_json() for k, s in jax_specs.items()}


def test_jax_reads_port_feature_files_byte_for_byte(tmp_path):
    rng = np.random.default_rng(2)
    arrays = sample_arrays(rng, 9)
    tensors = {
        k: (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
            if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v))
        for k, v in arrays.items()
    }
    tensors["scalar"] = torch.tensor(3.5)
    path = str(tmp_path / "b.sft")
    pt_ff.save_feature_file(path, tensors, {"target_repr": "hidden_state",
                                            "layers": [1, 2]})
    back, meta = jax_ff.load_feature_file(path)
    assert meta == {"target_repr": "hidden_state", "layers": "[1, 2]"}
    for name, t in tensors.items():
        assert back[name].shape == tuple(t.shape), name
        assert raw_bytes(back[name]) == raw_bytes(t), name
    again, _ = pt_ff.load_feature_file(path)
    assert float(again["scalar"]) == 3.5


def test_loader_and_collator_match_jax(tmp_path):
    write_dataset(str(tmp_path))
    meta = {"target_repr": "hidden_state"}
    jax_batches = list(JaxFeatureDataLoader(
        JaxFileFeatureStore(), JaxPaddingCollator(JaxCollatorConfig(MAXLEN)),
        refs=JaxOfflineManifestReader(str(tmp_path)).read(), batch_size=2,
        num_workers=0, metadata=meta,
    ))
    batches = list(FeatureDataLoader(
        FileFeatureStore(), PaddingCollator(CollatorConfig(MAXLEN)),
        refs=OfflineManifestReader(str(tmp_path)).read(), batch_size=2,
        num_workers=2, metadata=meta,
    ))
    assert len(batches) == len(jax_batches) == 3
    for got, ref in zip(batches, jax_batches):
        assert got.sample_ids == ref.sample_ids
        assert got.metadata == ref.metadata
        assert sorted(got.tensors) == sorted(ref.tensors)
        for name, arr in ref.tensors.items():
            assert tuple(got.tensors[name].shape) == arr.shape, name
            assert raw_bytes(got.tensors[name]) == raw_bytes(arr), name


@pytest.mark.parametrize("cast", [None, "float32"])
def test_padding_collator_matches_jax(cast):
    rng = np.random.default_rng(3)
    samples = [sample_arrays(rng, n) for n in (5, MAXLEN, MAXLEN + 4)]
    samples[0]["attention_mask"] = np.ones(5, np.int64)
    samples[1]["attention_mask"] = np.ones(MAXLEN, np.int64)
    samples[2]["attention_mask"] = np.ones(MAXLEN + 4, np.int64)
    for s in samples:
        s["position_ids"] = np.arange(len(s["input_ids"]), dtype=np.int64)
    ref = JaxPaddingCollator(JaxCollatorConfig(MAXLEN, pad_token_id=7,
                                               cast_float_dtype=cast))(
        samples, sample_ids=["a", "b", "c"])
    got = PaddingCollator(CollatorConfig(MAXLEN, pad_token_id=7,
                                         cast_float_dtype=cast))(
        [{k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
          if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v)
          for k, v in s.items()} for s in samples],
        sample_ids=["a", "b", "c"])
    assert got.sample_ids == ["a", "b", "c"]
    for name, arr in ref.tensors.items():
        assert tuple(got.tensors[name].shape) == arr.shape, name
        np.testing.assert_array_equal(
            got.tensors[name].float().numpy(), arr.astype(np.float32),
            err_msg=name)


def test_collator_derives_attention_mask():
    samples = [{"input_ids": torch.arange(3)}, {"input_ids": torch.arange(6)}]
    batch = PaddingCollator(CollatorConfig(4))(samples)
    assert batch.tensors["attention_mask"].tolist() == [[1, 1, 1, 0],
                                                        [1, 1, 1, 1]]
    assert batch.tensors["input_ids"].dtype == torch.int32


def test_manifest_refs_are_lazy(tmp_path):
    write_dataset(str(tmp_path), n=5)
    refs = OfflineManifestReader(str(tmp_path)).read()
    jax_refs = JaxOfflineManifestReader(str(tmp_path)).read()
    assert [r.sample_id for r in refs] == [f"sample-{i:04d}" for i in range(5)]
    assert [r.to_json() for r in refs] == [r.to_json() for r in jax_refs]
    assert list(refs[0].features) == ["__file__"]
    tensors = FileFeatureStore().fetch(refs[0])
    assert tensors["hidden_state"].dtype == torch.bfloat16
    bad = contracts.SampleRef("x", {"h": contracts.FeatureHandle(
        "mem://x#h", contracts.FeatureSpec("h", (1,), "int8"))})
    with pytest.raises(StoreError):
        FileFeatureStore().fetch(bad)


def test_vocab_mapping_files_cross_over(tmp_path):
    rng = np.random.default_rng(4)
    keep = np.sort(rng.choice(100, size=20, replace=False))
    t2d = np.zeros(100, bool)
    t2d[keep] = True
    d2t = (keep - np.arange(20)).astype(np.int32)
    jax_vocab.save_vocab_mapping(str(tmp_path / "j.npz"), t2d, d2t)
    got = pt_vocab.load_vocab_mapping(str(tmp_path / "j.npz"))
    pt_vocab.save_vocab_mapping(str(tmp_path / "p.npz"), t2d, d2t)
    back = jax_vocab.load_vocab_mapping(str(tmp_path / "p.npz"))
    for a, b in ((got, (t2d, d2t)), (back, (t2d, d2t))):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[1].dtype == np.int32


def test_contracts_keep_tensors_out_of_metadata():
    spec = contracts.FeatureSpec("h", (4, 3), "bfloat16")
    assert spec.nbytes == 24
    ref = contracts.SampleRef(
        "s", {"h": contracts.FeatureHandle("file:///x.sft#h", spec)})
    assert contracts.SampleRef.from_json(ref.to_json()) == ref
    with pytest.raises(contracts.ContractViolation):
        contracts.TrainBatch(tensors={}, metadata={"bad": torch.zeros(2)})
    with pytest.raises(ValueError):
        contracts.FeatureSpec("x", (1,), "complex64")
