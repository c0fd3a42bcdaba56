"""``chip_smoke.py`` rehearsed on the CPU at a small size.

On the CPU every kernel wrapper takes its plain version, so this checks the
script's data plane, slice driver and comparison, not the kernels; the card
run is ``python3 chip_smoke.py``."""

import importlib.util
import json
import os

import pytest
import torch

from specforge_tpu_torch.models.draft.llama_eagle3 import Eagle3Config
from specforge_tpu_torch.ops import loss_cuda

REPO = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per test worker (see test_torch_train.py's
    fixture of the same name: the default oversubscribes a shared CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def test_training_runs_on_the_cpu_at_small_size(smoke, tmp_path):
    """The training phase: cli train, the plain path from the same initial
    weights, the resume from step 2 and the launch-count check (no launch
    on CPU tensors)."""
    cfg = Eagle3Config(vocab_size=2048, draft_vocab_size=512, hidden_size=128,
                       intermediate_size=384, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=4096)
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    results, counts = smoke.run_training(
        cfg_path, torch.device("cpu"), 0, tmp_path / "work", max_length=64,
        min_len=40, head_std=0.2, overrides=['model.compute_dtype="float32"'])
    assert results["optimizer_steps"] == 4 and results["micro_batches"] == 8
    assert counts == dict.fromkeys(smoke.KERNEL_COUNTERS, 0)
    with pytest.raises(AssertionError, match="launches"):
        smoke.check_training_counts(counts, 8, 2)
    smoke.check_training_counts(
        {name: smoke.TTT * (8 if name in smoke.BACKWARD_KERNELS else 10)
         for name in counts}, 8, 2)
    # fp32 on both paths: the kernels' plain versions and the dense path
    # differ only in the order of their sums
    assert all(step["rel_diff"] < 1e-4 for step in results["loss_curve"])
    assert all(g["cosine"] > 0.9999 for g in results["step1_grads"].values())
    assert results["resume"]["steps"] == 4
    assert results["resume"]["max_rel_err"] < 1e-6
    assert "eval/simulated_acc_len" in results["final_eval"]


def test_ce_backward_check_rejects_broken_gradients(smoke):
    """The card's check of the fused CE gradient, fed on the CPU the plain
    gradient (which passes) and broken copies of it (which must fail): a
    row's last vector zeroed, the small entries zeroed, a masked row's
    entry set."""
    gen = torch.Generator().manual_seed(0)
    b, t, v = 2, 16, 2048
    logits = (torch.randn(b, t, v, generator=gen) * 2).to(torch.bfloat16)
    target = torch.softmax(torch.randn(b, t + 7, v, generator=gen) * 2,
                           dim=-1)[:, 3:3 + t]
    mask = (torch.rand(b, t, 1, generator=gen) > 0.2).int()
    mask[0, :2, 0] = torch.tensor([1, 0], dtype=torch.int32)
    _, stats = loss_cuda.loss_forward(logits, target, mask)
    g = torch.ones(())
    grad = loss_cuda.loss_backward(logits, target, stats, g)
    ref, tol = smoke.ce_backward_tolerance(logits, target, stats, g)
    assert smoke.ce_excess(grad, ref, tol) <= 0
    tail, leak = grad.clone(), grad.clone()
    tail[0, 0, -8:] = 0
    leak[0, 1, 0] = 1e-12
    small = grad.masked_fill(ref.abs() < ref.abs().mean(), 0)
    for broken in (tail, small, leak):
        assert smoke.ce_excess(broken, ref, tol) > 0


def test_exits_nonzero_without_cuda(smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("sys.argv", ["chip_smoke.py"])
    assert smoke.main() != 0
    assert capsys.readouterr().out == ""
