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
    weights, the resume from step 1, a warm start from step 1 and the
    launch-count check (no launch on CPU tensors)."""
    cfg = Eagle3Config(vocab_size=2048, draft_vocab_size=512, hidden_size=128,
                       intermediate_size=384, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=4096)
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    results, counts = smoke.run_training(
        cfg_path, torch.device("cpu"), 0, tmp_path / "work", max_length=64,
        min_len=40, head_std=0.2, overrides=['model.compute_dtype="float32"'])
    assert results["optimizer_steps"] == 2 and results["micro_batches"] == 4
    assert counts == dict.fromkeys(smoke.KERNEL_COUNTERS, 0)
    with pytest.raises(AssertionError, match="launches"):
        smoke.check_training_counts(counts, 4, 2)
    smoke.check_training_counts(
        {name: smoke.TTT * (4 if name in smoke.BACKWARD_KERNELS else 6)
         for name in counts}, 4, 2)
    # fp32 on both paths: the kernels' plain versions and the dense path
    # differ only in the order of their sums
    assert all(step["rel_diff"] < 1e-4 for step in results["loss_curve"])
    assert all(g["cosine"] > 0.9999 for g in results["step1_grads"].values())
    assert results["resume"]["steps"] == 2
    assert results["resume"]["max_rel_err"] < 1e-6
    assert "eval/simulated_acc_len" in results["final_eval"]
    # a warm start from the run's step-1 directory: its masters, a fresh
    # optimizer
    assert results["run_dir_warm_start"] == {
        "from": "smoke-step1", "tensors": results["run_dir_warm_start"][
            "tensors"], "bit_identical": True, "optimizer_fresh": True}


FAMILY_DRAFT = {
    "architectures": ["DominoDraftModel"], "vocab_size": 256,
    "hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
    "num_target_layers": 8, "block_size": 4,
    "max_position_embeddings": 256,
    "dflash_config": {"mask_token_id": 255, "target_layer_ids": [1, 5],
                      "projector_type": "domino", "pure_draft_prefix_len": 1,
                      "emb_dim": 16, "gru_hidden_dim": 16,
                      "shift_label": True},
}


DSPARK_HEADS = {
    "dspark": {"markov_rank": 8, "markov_head_type": "gated",
               "enable_confidence_head": True},
    "dspark_block7": {"markov_rank": 8, "markov_head_type": "vanilla",
                      "enable_confidence_head": True,
                      "confidence_head_with_markov": True},
}


@pytest.mark.parametrize("kind", ["domino", "dflash", "dspark",
                                  "dspark_block7"])
def test_family_training_runs_on_the_cpu_at_small_size(smoke, tmp_path, kind):
    """The DFlash-family phases: for domino and dspark, cli train (4 steps,
    one checkpoint, the metrics file; Domino's decaying lambda_base,
    DSpark's nine ratio metrics) and then the kernel-path and plain-path
    trainers; for dflash and dspark at blocks of 7, one step of the
    trainer's train step (through build_training_run) against the plain
    path; no launch on CPU tensors."""
    draft = dict(FAMILY_DRAFT)
    if kind == "dflash":
        draft["architectures"] = ["DFlashDraftModel"]
    if kind.startswith("dspark"):
        draft["architectures"] = ["DSparkDraftModel"]
        draft["dflash_config"] = {"mask_token_id": 255,
                                  "target_layer_ids": [1, 5],
                                  "projector_type": "dspark",
                                  **DSPARK_HEADS[kind]}
        if kind == "dspark_block7":
            draft["block_size"] = 7
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(draft))
    results, counts = smoke.run_family_training(
        kind, cfg_path, torch.device("cpu"), 0, tmp_path / "work",
        max_length=64, min_len=40, head_std=0.2,
        overrides=['model.compute_dtype="float32"', "training.num_anchors=8",
                   "training.objective_chunk_blocks=4"])
    steps = 4 if kind in smoke.FAMILY_CLI else 1
    assert results["optimizer_steps"] == steps
    assert results["micro_batches"] == 2 * steps
    assert counts == dict.fromkeys(smoke.DFLASH_COUNTERS, 0)
    with pytest.raises(AssertionError, match="launches"):
        smoke.check_family_counts(counts, 2 * steps, 2)
    smoke.check_family_counts(dict.fromkeys(counts, 4 * steps), 2 * steps, 2)
    # fp32 on both paths: the kernel's plain version and the chunked path
    # differ only in the order of their sums
    assert all(step["rel_diff"] < 1e-4 for step in results["loss_curve"])
    grads = results["step1_grads"].values()
    assert all(g["cosine"] > 0.9999 for g in grads if not g.get("both_zero"))
    if kind == "domino":
        # lambda_base is 1 at step 1: the correction head gets no gradient
        assert results["step1_grads"][
            "draft_model.embed_proj_1.weight"]["both_zero"]
        assert results["lambda_base"] == [1.0, 0.5, 0.0, 0.0]
    if kind in smoke.FAMILY_CLI:
        assert results["checkpoint"]["dir"] == f"{kind}-step4"
        # 8 anchors of 4 draft tokens against 64 context positions per row
        assert results["draft_tokens_per_s"] == pytest.approx(
            results["context_tokens_per_s"] * 32 / 64)
    if kind.startswith("dspark"):
        assert len(results["ratio_metrics"]) == steps
        assert all(set(r) == set(smoke.DSPARK_METRICS)
                   for r in results["ratio_metrics"])


def test_family_cli_needs_cuda_and_refuses_an_eval_pass(smoke, tmp_path,
                                                       monkeypatch):
    """Without --device and without a card, cli train raises; the family
    has no eval pass (its JAX strategies define none), so an eval set is
    refused by name."""
    from specforge_tpu_torch import cli
    from specforge_tpu_torch.application.composition import build_training_run
    from specforge_tpu_torch.config.schema import load_config

    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(FAMILY_DRAFT))
    run_json = smoke.family_run_json("domino", tmp_path, cfg_path,
                                     tmp_path / "target", 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "-c", str(run_json)])
    config = load_config(str(run_json), ['data.eval_data_path="eval"',
                                         "training.num_anchors=8"])
    with pytest.raises(NotImplementedError, match="eval pass"):
        build_training_run(config, device="cpu")


PEAGLE_DRAFT = {
    "architectures": ["PEagleDraftModel"], "vocab_size": 2048,
    "draft_vocab_size": 256, "hidden_size": 128, "intermediate_size": 256,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
    "num_hidden_layers": 2, "max_position_embeddings": 256,
}


def test_peagle_training_runs_on_the_cpu_at_small_size(smoke, tmp_path):
    """The P-EAGLE phase: cli train with factored moments, adam_b1 0, bf16
    moments and the row-sparse embedding update (2 steps, checkpoints at 1
    and 2), a second run reaching the same weights, the resume from step 1
    through the factored and row-sparse optimizer state, the dense
    embedding update against the row-sparse one, the dense plain path, the
    packed step; no launch on CPU tensors."""
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(PEAGLE_DRAFT))
    results, counts = smoke.run_peagle_training(
        cfg_path, torch.device("cpu"), 0, tmp_path / "work", max_length=64,
        min_len=40, pack_len=(8, 16), head_std=0.2,
        overrides=['model.compute_dtype="float32"'])
    assert results["optimizer_steps"] == 2 and results["micro_batches"] == 4
    assert counts == dict.fromkeys(smoke.PEAGLE_COUNTERS, 0)
    with pytest.raises(AssertionError, match="launches"):
        smoke.check_peagle_counts(counts, 4, 2)
    smoke.check_peagle_counts(
        {n: (4 if n.startswith("fused_ce") else 8) for n in counts}, 4, 2)
    assert results["checkpoint"]["dir"] == "peagle-step2"
    assert results["repeat_bit_exact"] and results["resume"]["bit_exact"]
    assert results["resume"]["steps"] == 2
    assert results["embedding_update"]["sparse_vs_dense_rel_err"] < 1e-5
    assert results["embedding_update"]["touched_rows"] > 0
    # fp32 on both paths: the kernels' plain versions and the dense path
    # differ only in the order of their sums
    assert all(step["rel_diff"] < 1e-4 for step in results["loss_curve"])
    grads = results["step1_grads"]
    assert all(g["cosine"] > 0.9999 for g in grads.values()
               if not g.get("both_zero"))
    assert "draft_model.embed_tokens.weight[rows]" in grads
    assert results["packed_step"]["documents_per_micro_batch"] == [8, 8]
    # 8 depths at S=64: 64 + 45 + 32 + 22 + 16 + 13 + 13 + 13 rows a row
    assert results["sampled_rows_per_micro_batch"] == 2 * 218


def test_peagle_cli_needs_cuda_and_refuses_what_it_lacks(smoke, tmp_path,
                                                        monkeypatch):
    """Without --device and without a card, cli train raises; P-EAGLE has
    no eval pass, and document packing is refused for a strategy that does
    not read document boundaries."""
    from specforge_tpu_torch import cli
    from specforge_tpu_torch.application.composition import build_training_run
    from specforge_tpu_torch.config.schema import load_config

    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(PEAGLE_DRAFT))
    run_json = smoke.peagle_run_json(tmp_path, cfg_path, tmp_path / "target",
                                     64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "-c", str(run_json)])
    config = load_config(str(run_json), ['data.eval_data_path="eval"'])
    with pytest.raises(NotImplementedError, match="eval pass"):
        build_training_run(config, device="cpu")
    family = tmp_path / "family"
    family.mkdir()
    draft = family / "draft.json"
    draft.write_text(json.dumps(FAMILY_DRAFT))
    config = load_config(str(smoke.family_run_json(
        "domino", family, draft, family / "target", 64)),
        ["data.pack_documents=true"])
    with pytest.raises(ValueError, match="pack_documents"):
        build_training_run(config, device="cpu")


def test_usp_training_runs_on_the_cpu_at_small_size(smoke, tmp_path):
    """The USP phase: 4 ranks (``chip_smoke.py --usp-rank``, gloo on the
    CPU) run cli train on a 2×2 grid, agree bit-exactly, resume
    bit-exactly and match one process on the TTT path; the launch-count
    check (no launch on CPU tensors)."""
    cfg = Eagle3Config(vocab_size=2048, draft_vocab_size=512, hidden_size=128,
                       intermediate_size=384, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=4096)
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    results, counts = smoke.run_usp_training(
        cfg_path, torch.device("cpu"), 0, tmp_path / "work", max_length=64,
        min_len=48, head_std=0.2, overrides=['model.compute_dtype="float32"'])
    assert results["optimizer_steps"] == 2 and results["micro_batches"] == 4
    assert results["transport"] == "gloo"
    assert counts == dict.fromkeys(smoke.LSE_KERNELS, 0)
    assert sorted(r["chunk"] for r in results["ranks"]) == [0, 1, 2, 3]
    # fp32 on both paths: the ring and the one-process TTT attention differ
    # only in the order of their sums
    assert all(step["rel_diff"] < 1e-4 for step in results["loss_curve"])
    assert all(g["cosine"] > 0.9999 for g in results["step1_grads"].values())
    with pytest.raises(AssertionError, match="lse_attention_fwd"):
        smoke.check_usp_counts(results["rank_launches"], 4)
    per_micro = {n: smoke.TTT * (2 if n.startswith("lse") else 1)
                 for n in smoke.USP_COUNTERS if not n.startswith("ttt")}
    launches = {n: 4 * per_micro.get(n, 0) for n in smoke.USP_COUNTERS}
    smoke.check_usp_counts([launches] * 4, 4)
    launches["ttt_flash_attention_fwd"] = 1
    with pytest.raises(AssertionError, match="ttt_flash_attention_fwd"):
        smoke.check_usp_counts([launches], 4)


@pytest.mark.parametrize("name", ["llama3_70b", "qwen2_5_vl_7b",
                                  "deepseek_v2_lite"])
def test_offline_leftovers_run_on_the_cpu_at_small_size(smoke, tmp_path,
                                                       monkeypatch, name):
    """The offline_leftovers phase: each draft of ``LEFTOVER_RUNS`` cut to
    hidden 128 with its own RoPE type (llama3, mrope on [3, S] position ids
    over a vision span, yarn) and its layout of heads, through cli train
    (Llama: reference ``.ckpt`` features, two gzipped, and a warm start
    from an export written by the phase), the kernel-path trainer (its
    warm-started weights, a bit-exact repeat) and the plain path; the
    launch-count check (no launch on CPU tensors)."""
    spec = dict(smoke.LEFTOVER_RUNS[name])
    draft = json.loads(spec["config"].read_text())
    heads, kv_heads = draft["num_attention_heads"], draft["num_key_value_heads"]
    g = heads // kv_heads
    small_kv = 4 if g == 1 else 1
    draft.update(hidden_size=128, intermediate_size=256, vocab_size=2048,
                 draft_vocab_size=512, head_dim=32,
                 num_attention_heads=small_kv * g,
                 num_key_value_heads=small_kv)
    if name == "qwen2_5_vl_7b":
        draft["rope_scaling"] = {"type": "mrope", "mrope_section": [4, 6, 6]}
        monkeypatch.setattr(smoke, "IMAGE_TOKEN_ID", 7)
        monkeypatch.setattr(smoke, "VISION_GRID", (1, 2, 4))
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(draft))
    spec["config"] = cfg_path
    results, counts = smoke.run_leftover(
        spec, torch.device("cpu"), 0, tmp_path / "work", max_length=64,
        min_len=40, head_std=0.2, overrides=['model.compute_dtype="float32"'])
    steps = spec["files"] // smoke.BATCH // spec["accum"]
    assert results["optimizer_steps"] == steps
    assert len(results["loss_curve"]) == steps
    assert counts == dict.fromkeys(smoke.KERNEL_COUNTERS, 0)
    smoke.check_training_counts(
        dict.fromkeys(counts, smoke.TTT * results["micro_batches"]),
        results["micro_batches"], 0)
    assert results["repeat_bit_exact"]
    # fp32 on both paths: the plain versions and the dense path differ only
    # in the order of their sums
    assert results["step1"]["rel_diff"] < 1e-4
    assert results["step1_grads"]["min_cosine"] > 0.9999
    if name == "llama3_70b":
        assert results["warm_start"]["bit_identical"]
        assert results["feature_files"][:2] == ["sample-0000.ckpt.gz",
                                                "sample-0001.ckpt.gz"]
        assert results["feature_files"][2].endswith(".ckpt")
        assert "micro_step_ms" in results
    else:
        assert "warm_start" not in results


def test_usp_training_takes_mrope_positions_on_the_cpu(smoke, tmp_path,
                                                       monkeypatch):
    """The USP phase on an mrope draft whose features carry [3, S] position
    ids over a vision span: every rank cuts its chunk (and halo) of the 3-D
    ids on their sequence axis, and the 4 ranks match one process."""
    cfg = dict(vocab_size=2048, draft_vocab_size=512, hidden_size=128,
               intermediate_size=384, num_attention_heads=4,
               num_key_value_heads=2, head_dim=32,
               max_position_embeddings=4096,
               rope_scaling={"type": "mrope", "mrope_section": [4, 6, 6]})
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(cfg))
    monkeypatch.setattr(smoke, "IMAGE_TOKEN_ID", 7)
    monkeypatch.setattr(smoke, "VISION_GRID", (1, 2, 4))
    write = smoke.write_features
    monkeypatch.setattr(smoke, "write_features",
                        lambda *a, **k: write(*a, **k, fmt="mrope"))
    results, _ = smoke.run_usp_training(
        cfg_path, torch.device("cpu"), 0, tmp_path / "work", max_length=64,
        min_len=48, head_std=0.2, overrides=['model.compute_dtype="float32"'])
    specs, _ = smoke.read_feature_specs(
        str(next((tmp_path / "work" / "train").glob("*.sft"))))
    assert specs["position_ids"].shape[0] == 3
    assert all(step["rel_diff"] < 1e-4 for step in results["loss_curve"])
    assert all(g["cosine"] > 0.9999 for g in results["step1_grads"].values())


def test_mesh_training_runs_on_the_cpu_at_small_size(smoke, tmp_path,
                                                    monkeypatch):
    """The mesh phase: 4 ranks (``chip_smoke.py --mesh-rank``, gloo on the
    CPU) run cli train for EAGLE3 at dp 2 × fsdp 2 (4 steps, eval, a resume
    from step 2), P-EAGLE at fsdp 4, Domino at dp 2 × fsdp 2 and EAGLE3 at
    fsdp 2 × sp_ring 2, agree bit-exactly and match one process of the same
    global batch; each rank holds less than one process's state; the
    launch-count check (no launch on CPU tensors)."""
    common = dict(vocab_size=2048, hidden_size=128, intermediate_size=256,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                  num_hidden_layers=2, max_position_embeddings=4096)
    drafts = {
        "eagle3": Eagle3Config(vocab_size=2048, draft_vocab_size=512,
                               hidden_size=128, intermediate_size=384,
                               num_attention_heads=4, num_key_value_heads=2,
                               max_position_embeddings=4096).to_dict(),
        "peagle": dict(common, architectures=["PEagleDraftModel"],
                       draft_vocab_size=512),
        "domino": dict(common, architectures=["DominoDraftModel"],
                       num_target_layers=8, block_size=4,
                       mask_token_id=2047, projector_type="domino",
                       emb_dim=32, gru_hidden_dim=32, pure_draft_prefix_len=1,
                       shift_label=True),
    }
    paths = {}
    for name, draft in drafts.items():
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(draft))
    runs = {name: (paths["eagle3" if name == "usp" else name], *run[1:6],
                   40, 64) for name, run in smoke.MESH_RUNS.items()}
    monkeypatch.setattr(smoke, "MESH_RUNS", runs)
    results, counts = smoke.run_mesh_training(
        torch.device("cpu"), 0, tmp_path / "work", head_std=0.2,
        overrides=['model.compute_dtype="float32"'])
    assert sorted(results["runs"]) == ["domino", "eagle3", "peagle", "usp"]
    eagle3 = results["runs"]["eagle3"]
    assert eagle3["optimizer_steps"] == 4 and eagle3["micro_batches"] == 8
    assert eagle3["resume"]["bit_exact"] and eagle3["final_eval"]
    assert eagle3["resume"]["from"] == "mesh_eagle3-step2"
    # fp32 on both sides: the mesh and one process differ only in the
    # order of their sums
    assert all(g["cosine"] > 0.9999 for g in eagle3["step1_grads"].values())
    for name, res in results["runs"].items():
        assert res["transport"] == "gloo" and res["ranks_bit_identical"]
        assert all(s["rel_diff"] < 1e-4 for s in res["loss_curve"]), name
        if res["fsdp"] > 1:
            assert res["sharded_tensors"] > 0
            assert res["state_bytes_ratio"]["masters"] < 1.0, name
        assert counts[name] == dict.fromkeys(smoke.MESH_COUNTERS, 0)
    with pytest.raises(AssertionError, match="launched 0 times"):
        smoke.check_mesh_counts(results)
    for name, res in results["runs"].items():
        res["rank_launches"] = [smoke.mesh_expected_launches(
            name, res["micro_batches"], res["eval_forwards"],
            res["layers"])] * 4
    smoke.check_mesh_counts(results)
    assert results["runs"]["usp"]["rank_launches"][0][
        "lse_attention_fwd"] == smoke.TTT * 2


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
