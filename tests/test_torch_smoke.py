"""``chip_smoke.py`` rehearsed on the CPU at a small size.

On the CPU every kernel wrapper takes its plain version, so this checks the
script's data plane, slice driver and comparison, not the kernels; the card
run is ``python3 chip_smoke.py``."""

import importlib.util
import os

import pytest
import torch

from specforge_tpu_torch.models.draft.llama_eagle3 import Eagle3Config

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_slice_runs_on_the_cpu_at_small_size(smoke, tmp_path):
    cfg = Eagle3Config(vocab_size=2048, draft_vocab_size=512, hidden_size=128,
                       intermediate_size=384, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=4096)
    kernel, plain, counted = smoke.run_slice(
        cfg, torch.device("cpu"), 0, tmp_path, dtype=torch.float32,
        max_length=64, n_files=4, min_len=40, head_std=0.2)
    assert counted["batches"] == 2 and counted["forwards"] == 3
    # CPU tensors take the plain versions, which count no launch
    assert counted["launches"] == {"ttt_flash_attention_fwd": 0,
                                   "fused_ce_fwd": 0}
    assert 4 * 40 <= counted["real_tokens"] <= counted["padded_tokens"] == 256
    # fp32 on both paths: the flash and dense attention differ only in the
    # order of their sums
    assert smoke.compare_slice(kernel, plain) < 1e-4
    assert len(kernel["eval"]) == 3 * smoke.TTT + 1


def test_exits_nonzero_without_cuda(smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py"])
    assert smoke.main() != 0
    assert capsys.readouterr().out == ""
