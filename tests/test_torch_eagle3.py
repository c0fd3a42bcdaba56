"""The PyTorch port's EAGLE3 TTT forward against the JAX package, on the CPU.

Small size (hidden 128, 4 heads, 2 kv heads, S 64, vocab 2048, draft vocab
512, TTT 7) in fp32. The JAX model runs with the ``"dense"`` backend; the
port runs with ``"pallas"`` (whose kernel wrapper takes its plain version on
CPU tensors) and with ``"dense"``. Weights cross over through
``params_from_jax``. Tolerances are those of tests/test_eagle3_parity.py."""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from specforge_tpu.algorithms.eagle3.model import (
    OnlineEagle3Model as JaxOnlineEagle3Model,
)
from specforge_tpu.data.collator import CollatorConfig as JaxCollatorConfig
from specforge_tpu.data.collator import PaddingCollator as JaxPaddingCollator
from specforge_tpu.eval.evaluator import Evaluator as JaxEvaluator
from specforge_tpu.models.draft.llama_eagle3 import (
    Eagle3Config as JaxEagle3Config,
)
from specforge_tpu.models.draft.llama_eagle3 import LlamaEagle3Draft as JaxDraft
from specforge_tpu.runtime.data_plane.feature_dataloader import (
    FeatureDataLoader as JaxFeatureDataLoader,
)
from specforge_tpu.runtime.data_plane.feature_file import (
    save_feature_file as jax_save_feature_file,
)
from specforge_tpu.runtime.data_plane.feature_store import (
    FileFeatureStore as JaxFileFeatureStore,
)
from specforge_tpu.runtime.data_plane.offline_reader import (
    OfflineManifestReader as JaxOfflineManifestReader,
)
from specforge_tpu.training.strategies import (
    Eagle3TrainStrategy as JaxEagle3TrainStrategy,
)
from specforge_tpu.training.strategies import StepContext as JaxStepContext
from specforge_tpu_torch import utils
from specforge_tpu_torch.algorithms.eagle3.model import OnlineEagle3Model
from specforge_tpu_torch.convert import params_from_jax
from specforge_tpu_torch.data.collator import CollatorConfig, PaddingCollator
from specforge_tpu_torch.eval.evaluator import Evaluator
from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    LlamaEagle3Draft,
)
from specforge_tpu_torch.runtime.data_plane.feature_dataloader import (
    FeatureDataLoader,
)
from specforge_tpu_torch.runtime.data_plane.feature_store import FileFeatureStore
from specforge_tpu_torch.runtime.data_plane.offline_reader import (
    OfflineManifestReader,
)
from specforge_tpu_torch.training.strategies import Eagle3TrainStrategy

B, S, V, VD, HID, LENGTH = 2, 64, 2048, 512, 128, 7
RTOL, ATOL = 2e-4, 2e-5  # tests/test_eagle3_parity.py
CFG_KW = dict(vocab_size=V, draft_vocab_size=VD, hidden_size=HID,
              intermediate_size=3 * HID, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=4096)
REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per test worker (see test_torch_train.py's
    fixture of the same name: the default oversubscribes a shared CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def vocab_maps(rng):
    keep = np.sort(rng.choice(V, size=VD, replace=False))
    t2d = np.zeros(V, bool)
    t2d[keep] = True
    return t2d, (keep - np.arange(VD)).astype(np.int32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    t2d, d2t = vocab_maps(rng)
    jax_model = JaxOnlineEagle3Model(
        draft_model=JaxDraft(JaxEagle3Config(**CFG_KW), dtype=jnp.float32),
        length=LENGTH,
    )
    attention_mask = np.ones((B, S), np.int32)
    attention_mask[1, 50:] = 0
    batch = dict(
        input_ids=rng.integers(0, V, size=(B, S)).astype(np.int32),
        attention_mask=attention_mask,
        loss_mask=(rng.random((B, S, 1)) > 0.2).astype(np.int32),
        hidden_state=rng.normal(size=(B, S, 3 * HID)).astype(np.float32),
        target=(rng.normal(size=(B, S, V)) * 2).astype(np.float32),
    )
    variables = jax_model.init(
        jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in (
            "input_ids", "attention_mask", "loss_mask", "hidden_state",
            "target"))
    )
    variables = {
        "params": variables["params"],
        "buffers": {"draft_model": {"t2d": jnp.asarray(t2d),
                                    "d2t": jnp.asarray(d2t)}},
    }
    head = (rng.normal(size=(V, HID)) * 0.2).astype(np.float32)
    return jax_model, variables, batch, head


def port_model(variables, backend):
    draft = LlamaEagle3Draft(Eagle3Config(**CFG_KW), dtype=torch.float32,
                             attention_backend=backend, device="cpu")
    model = OnlineEagle3Model(draft, length=LENGTH)
    model.load_state_dict(params_from_jax(jax.device_get(variables)))
    return model


def test_params_from_jax_covers_the_state_dict(setup):
    _, variables, _, _ = setup
    state = params_from_jax(jax.device_get(variables))
    model = port_model(variables, "dense")
    expected = model.state_dict()
    assert sorted(state) == sorted(expected)
    for name, value in state.items():
        assert value.shape == expected[name].shape, name
    p = variables["params"]["draft_model"]
    np.testing.assert_array_equal(
        state["draft_model.midlayer.self_attn.qkv_proj.weight"].numpy(),
        np.asarray(p["midlayer"]["self_attn"]["qkv_proj"]["kernel"]).T,
    )
    assert state["draft_model.d2t"].dtype == torch.int64


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_ttt_forward_matches_jax(setup, backend):
    jax_model, variables, batch, _ = setup
    names = ("input_ids", "attention_mask", "loss_mask", "hidden_state",
             "target")
    ref = jax_model.apply(variables, *(jnp.asarray(batch[k]) for k in names))
    with torch.no_grad():
        out = port_model(variables, backend)(
            *(torch.from_numpy(batch[k]) for k in names))
    for field in ("plosses", "acceptance_rates", "acces", "metric_losses",
                  "acceptance_nums", "acceptance_denoms", "metric_denoms"):
        np.testing.assert_allclose(
            getattr(out, field).numpy(), np.asarray(getattr(ref, field)),
            rtol=RTOL, atol=ATOL, err_msg=field,
        )
    np.testing.assert_allclose(out.metric_corrects.numpy(),
                               np.asarray(ref.metric_corrects), atol=1e-3)
    assert out.plosses.shape == (LENGTH,)


def offline_batch(batch):
    """The fixture batch as an offline hidden-state capture."""
    rng = np.random.default_rng(1)
    tensors = dict(batch)
    tensors["target"] = rng.normal(size=(B, S, HID)).astype(np.float32)
    return tensors


def test_forward_loss_compact_teacher_matches_jax(setup):
    jax_model, variables, batch, head = setup
    tensors = offline_batch(batch)
    meta = {"target_repr": "hidden_state"}
    ref = JaxEagle3TrainStrategy(jax_model, compact_teacher=True).forward_loss(
        variables, {k: jnp.asarray(v) for k, v in tensors.items()},
        {"target_head_weight": jnp.asarray(head)}, JaxStepContext(), meta,
    )
    strategy = Eagle3TrainStrategy(port_model(variables, "pallas"),
                                   compact_teacher=True)
    with torch.no_grad():
        out = strategy.forward_loss(
            {k: torch.from_numpy(v) for k, v in tensors.items()},
            {"target_head_weight": torch.from_numpy(head)}, metadata=meta,
        )
    np.testing.assert_allclose(float(out.loss), float(ref.loss), rtol=RTOL,
                               atol=ATOL)
    assert sorted(out.metrics) == sorted(ref.metrics)
    for key, value in ref.metrics.items():
        np.testing.assert_allclose(float(out.metrics[key]), float(value),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    for key, (num, den) in ref.ratio_metrics.items():
        got_num, got_den = out.ratio_metrics[key]
        np.testing.assert_allclose(float(got_num), float(num), rtol=RTOL,
                                   atol=1e-3, err_msg=key)
        np.testing.assert_allclose(float(got_den), float(den), rtol=RTOL,
                                   err_msg=key)


def write_features(root, n=6, seed=2):
    """Offline feature files written by the JAX package's writer."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        seq = int(rng.integers(40, S + 1))
        jax_save_feature_file(
            os.path.join(root, f"sample-{i:04d}.sft"),
            {
                "input_ids": rng.integers(0, V, size=(seq,)).astype(np.int64),
                "loss_mask": (rng.random(seq) > 0.25).astype(np.int64),
                "hidden_state": rng.normal(size=(seq, 3 * HID)).astype(
                    ml_dtypes.bfloat16),
                "target": rng.normal(size=(seq, HID)).astype(
                    ml_dtypes.bfloat16),
            },
            {"target_repr": "hidden_state"},
        )


def test_evaluator_matches_jax(setup, tmp_path):
    jax_model, variables, _, head = setup
    write_features(str(tmp_path))
    meta = {"target_repr": "hidden_state"}
    jax_loader = JaxFeatureDataLoader(
        JaxFileFeatureStore(),
        JaxPaddingCollator(JaxCollatorConfig(S, cast_float_dtype="float32")),
        refs=JaxOfflineManifestReader(str(tmp_path)).read(), batch_size=B,
        num_workers=0, metadata=meta,
    )
    ref = JaxEvaluator(JaxEagle3TrainStrategy(jax_model)).run(
        variables, jax_loader, {"target_head_weight": jnp.asarray(head)})
    loader = FeatureDataLoader(
        FileFeatureStore(),
        PaddingCollator(CollatorConfig(S, cast_float_dtype="float32")),
        refs=OfflineManifestReader(str(tmp_path)).read(), batch_size=B,
        num_workers=2, metadata=meta,
    )
    got = Evaluator(Eagle3TrainStrategy(port_model(variables, "pallas"))).run(
        loader, {"target_head_weight": torch.from_numpy(head)})
    assert sorted(got) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(got[key], value, rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_qwen3_8b_config_reads_like_jax():
    path = os.path.join(REPO, "configs", "qwen3-8b-eagle3.json")
    cfg = Eagle3Config.from_file(path)
    assert cfg.to_dict() == JaxEagle3Config.from_file(path).to_dict()
    assert (cfg.hidden_size, cfg.resolved_head_dim, cfg.draft_vocab_size) == (
        4096, 128, 32000)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        utils.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaEagle3Draft(Eagle3Config(**CFG_KW))
    assert utils.resolve_device("cpu") == torch.device("cpu")
