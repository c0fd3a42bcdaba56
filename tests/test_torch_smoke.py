"""``chip_smoke.py`` rehearsed on the CPU at a small size.

On the CPU every kernel wrapper takes its plain version, so this checks the
script's data plane, slice driver and comparison, not the kernels; the card
run is ``python3 chip_smoke.py``."""

import importlib.util
import json
import os

import numpy as np
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


#: the capture phase's target cut to the CPU: a qwen3 of 4 layers at the
#: tiny draft's width
TINY_TARGET = dict(vocab_size=2048, hidden_size=128, intermediate_size=256,
                   num_hidden_layers=4, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=32)


def test_training_runs_on_the_cpu_at_small_size(smoke, tmp_path):
    """The capture phase (a random qwen3 target written as shards with an
    index, conversations through the qwen template and parser, the runner,
    the read-back, alone-vs-batch and fp32 checks, the vocab mapping),
    then the training phase on its features: cli train, the exports of the
    final checkpoint, the plain path from the same initial weights, the
    resume from step 1, a warm start from step 1 and the launch-count
    check (no launch on CPU tensors)."""
    cfg = Eagle3Config(vocab_size=2048, draft_vocab_size=512, hidden_size=128,
                       intermediate_size=384, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=4096)
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    work = tmp_path / "work"
    capture, captured = smoke.capture_phase(
        cfg_path, torch.device("cpu"), 0, work,
        target_config={**smoke.QWEN3_8B_TARGET, **TINY_TARGET},
        max_length=64, min_len=40, std=0.2)
    assert capture["capture_layers"] == [1, 1, 0]  # (1, n//2-1, n-4), n = 4
    assert capture["files_checked"] == smoke.TRAIN_FILES + smoke.EVAL_FILES
    assert all(40 <= n <= 64 for n in capture["sample_lengths"])
    assert len(list((work / "target").glob("*.safetensors"))) == 2
    assert capture["vocab"]["draft_vocab"] == 512
    # the stand-in tokenizer's ids spread over the whole vocabulary
    assert capture["vocab"]["id_range"][1] > 1900
    for errors in (capture["bf16_vs_fp32_rel_l2"],
                   capture["alone_vs_batch_rel_l2"]):
        assert set(errors) == {"layer_1", "layer_0", "last_hidden"}
    results, counts = smoke.run_training(
        cfg_path, torch.device("cpu"), 0, work, captured, max_length=64,
        overrides=['model.compute_dtype="float32"'])
    for fmt in ("sglang", "hf"):
        assert results["export"][fmt]["bit_identical"]
    assert results["export"]["from"] == "smoke-step2"
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


def test_serving_phase_runs_on_the_cpu_at_small_size(smoke, tmp_path):
    """The serving phase on the capture phase's tiny target and the
    training phase's SGLang export: the four decoders equal in fp32, the
    bf16 timings, agreement and accept lengths, and the server process on
    the CPU answering as this process's decoder does (no graphs on the
    CPU, so no replays)."""
    cfg = Eagle3Config(vocab_size=2048, draft_vocab_size=512, hidden_size=128,
                       intermediate_size=384, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=4096)
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    work = tmp_path / "work"
    target = {**smoke.QWEN3_8B_TARGET, **TINY_TARGET, "num_hidden_layers": 6}
    _, captured = smoke.capture_phase(
        cfg_path, torch.device("cpu"), 0, work, target_config=target,
        max_length=64, min_len=40, std=0.2)
    runs = work / "runs"
    run = smoke.training_run_json(work, cfg_path, captured["target"], 64,
                                  captured["vocab_mapping"])
    from specforge_tpu_torch import cli

    assert cli.main(["train", "-c", str(run), "--device", "cpu", "--set",
                     'model.compute_dtype="float32"']) == 0
    step = smoke.CheckpointManager.resolve_step_dir(str(runs))
    smoke.check_exports(runs, smoke.Path(step), cfg_path, captured["target"],
                        work / "export", torch.device("cpu"))
    assert not (work / "export" / "hf").exists()
    results = smoke.serving_phase(
        captured, work / "export" / "sglang", work, 0, torch.device("cpu"),
        prompt_len=(16, 40), new_tokens=8, max_len=128, server_prompt=16,
        server_new=6)
    assert results["capture_layers"] == [1, 2, 2]
    assert all(16 <= n <= 40 for n in results["prompt_lengths"])
    assert results["fp32"]["decoders_equal"]
    bf16 = results["bf16"]
    assert bf16["graph_replays"] == bf16["plain_graph_replays"] == 0
    assert bf16["rounds"] >= len(results["prompt_lengths"])
    assert 0.0 <= bf16["spec_agreement"] <= 1.0
    assert bf16["mean_accept_length"] >= 1.0
    server = results["server"]
    assert server["outputs_equal"] and server["exit_code"] is not None
    assert server["health"]["family"] == "Eagle3SpecDecoder"


#: the block-serving drafts at the tiny target's widths: the Qwen3-8B
#: configs' capture layers (5 of 36) and heads, two layers, blocks of 4
BLOCK_DRAFT = {
    "vocab_size": 2048, "hidden_size": 128, "intermediate_size": 256,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
    "num_hidden_layers": 2, "num_target_layers": 36, "block_size": 4,
    "max_position_embeddings": 4096,
}
BLOCK_HEADS = {
    "domino": {"projector_type": "domino", "pure_draft_prefix_len": 1,
               "emb_dim": 16, "gru_hidden_dim": 16, "shift_label": True},
    "dflash": {},
    "dspark": {"projector_type": "dspark", "markov_rank": 8,
               "markov_head_type": "gated", "enable_confidence_head": True},
}


def test_dflash_serving_phase_runs_on_the_cpu_at_small_size(smoke, tmp_path):
    """The block serving phase on the capture phase's tiny 6-layer target:
    the dflash-layout capture at the evenly spaced layers with repeated ids
    (bit-identical to the eagle layout's shared columns), the Domino, DSpark
    and DFlash family phases on those features (Domino's and DSpark's
    exports), the Domino export served in full (the decoders equal in fp32,
    bf16 agreement, the server process answering as this process's
    decoder), the DSpark export and a random DFlash export the short way;
    no kernel launch and no graph on the CPU."""
    eagle = Eagle3Config(vocab_size=2048, draft_vocab_size=512,
                         hidden_size=128, intermediate_size=384,
                         num_attention_heads=4, num_key_value_heads=2,
                         max_position_embeddings=4096)
    eagle_path = tmp_path / "eagle.json"
    eagle_path.write_text(json.dumps(eagle.to_dict()))
    configs = {}
    for kind, head in BLOCK_HEADS.items():
        configs[kind] = tmp_path / f"{kind}.json"
        configs[kind].write_text(json.dumps({
            **BLOCK_DRAFT, "dflash_config": {
                "mask_token_id": 2047,
                "target_layer_ids": [1, 9, 17, 25, 33], **head}}))
    work = tmp_path / "work"
    target = {**smoke.QWEN3_8B_TARGET, **TINY_TARGET, "num_hidden_layers": 6}
    _, captured = smoke.capture_phase(
        eagle_path, torch.device("cpu"), 0, work, target_config=target,
        max_length=64, min_len=40, std=0.2)
    trained = []
    results, families = smoke.dflash_serving_phase(
        captured, work, 0, torch.device("cpu"), 6, configs=configs,
        on_training=lambda *done: trained.append(done),
        prompt_len=(16, 40), new_tokens=8, max_len=128, max_length=64,
        batch=4, family_length=64, server_prompt=16, server_new=6,
        family_overrides=['model.compute_dtype="float32"',
                          "training.num_anchors=8",
                          "training.objective_chunk_blocks=4"])
    capture = results["capture"]
    assert capture["capture_layers"] == [1, 2, 2, 2, 3]
    assert capture["eagle_capture_layers"] == [1, 2, 2]
    assert capture["bit_identical"] and capture["files"] == smoke.TRAIN_FILES
    # a file's layer-1 columns (one a layout) and layer-2 columns (two in
    # the eagle layout, three in the dflash one)
    assert capture["columns_compared"] == smoke.TRAIN_FILES * 7
    steps = smoke.TRAIN_FILES // (smoke.BATCH * smoke.ACCUM)
    assert [t[0] for t in trained] == list(smoke.BLOCK_FAMILIES)
    for kind, done, counts in trained:
        assert families[kind] == (done, counts)
        assert done["optimizer_steps"] == steps
        assert counts == dict.fromkeys(smoke.DFLASH_COUNTERS, 0)
        if kind in smoke.FAMILY_CLI:
            assert done["export"]["from"] == f"{kind}-step{steps}"
    for kind in ("domino", "dflash", "dspark"):
        checks = results[kind]
        assert checks["fp32"]["decoders_equal"]
        bf16 = checks["bf16"]
        assert bf16["graph_replays"] == 0 and bf16["rounds"] >= 1
        assert bf16["dflash_fwd_launches"]["total"] == 0
        assert 0.0 <= bf16["spec_agreement"] <= 1.0
    assert [results[k]["draft"] for k in ("domino", "dflash", "dspark")] == [
        "DominoDraftModel", "DFlashDraftModel", "DSparkDraftModel"]
    assert len(results["domino"]["fp32"]["prompts"]) == (
        smoke.BLOCK_FP32_PROMPTS)
    server = results["server"]
    assert server["outputs_equal"] and server["exit_code"] is not None
    assert server["health"]["block_size"] == 4
    assert "kernel_at_serving_shape" not in results


def test_serving_gaps_study_runs_on_the_cpu_at_small_size(smoke, tmp_path):
    """The study behind the bf16 near-tie bound at a tiny width: the
    sound verify block moves greedy's margins by no more than the bound,
    each planted fault moves them by more and flips tokens, and the chain
    and plain decoders leave greedy only at near-ties."""
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(Eagle3Config(
        vocab_size=2048, draft_vocab_size=512, hidden_size=128,
        intermediate_size=384, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=4096).to_dict()))
    target = {**smoke.QWEN3_8B_TARGET, **TINY_TARGET, "num_hidden_layers": 6}
    results = smoke.serving_gaps_phase(
        0, target, device=torch.device("cpu"), seeds=2, prompts=2,
        prompt_len=(16, 40), new_tokens=16, max_len=128,
        draft_config=cfg_path)
    verify = results["verify"]
    assert verify["sound"]["positions"] == 2 * 2 * 15
    assert verify["sound"]["shift_ulps"]["max"] <= smoke.SERVING_TIE_ULPS
    for fault in ("wrong_position", "stale_slot"):
        assert verify[fault]["shift_ulps"]["max"] > smoke.SERVING_TIE_ULPS
        assert verify[fault]["flips"] > 0
    assert verify["stale_slot"]["prompts_past_bound"] > 0
    assert all(len(acc["max_excess_ulps"]) == 4
               for acc in results["decoders"].values())
    smoke.check_serving_gaps(results)
    results["decoders"]["generate_fused"]["max_excess_ulps"][0] = (
        smoke.SERVING_TIE_ULPS + 1)
    with pytest.raises(AssertionError, match="not near-ties"):
        smoke.check_serving_gaps(results)


def test_online_phase_runs_on_the_cpu_at_small_size(smoke, tmp_path):
    """The online phase: ``cli train --managed-local --device cpu`` on the
    online example (the store built by g++, the port's capture server on a
    random 4-layer qwen3, producer, consumer), the inline features against
    the runner in this process bit for bit, the ledger, the store, and the
    online step-1 loss against the offline ``cli train`` run; on the CPU no
    kernel launches."""
    cfg = Eagle3Config(vocab_size=2048, draft_vocab_size=512, hidden_size=128,
                       intermediate_size=384, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=4096)
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    target = smoke.write_capture_target(
        tmp_path / "target", {**smoke.QWEN3_8B_TARGET, **TINY_TARGET},
        torch.device("cpu"), 0, 0.2)
    results = smoke.online_phase(
        cfg_path, {"target": target, "vocab_mapping": None},
        tmp_path / "online", 0, torch.device("cpu"), max_length=64,
        min_len=40)
    assert results["supervisor_rc"] == 0
    assert results["server"]["device"] == "cpu"
    assert results["producer"]["samples_produced"] == smoke.ONLINE_PROMPTS
    assert results["store"]["objects"] == 0
    assert results["store"]["puts"] == 4 * smoke.ONLINE_PROMPTS
    assert results["ledger"] == {"durable_step": smoke.ONLINE_STEPS,
                                 "acked": smoke.ONLINE_PROMPTS}
    assert results["launches"] == dict.fromkeys(smoke.KERNEL_COUNTERS, 0)
    assert results["features"]["bit_identical"]
    assert results["step1_loss"]["rel_diff"] == 0.0
    assert len(results["consumer"]["step_s"]) == smoke.ONLINE_STEPS
    assert all(40 <= n <= 64 for n in results["prompt_lengths"])


def test_online_phase_runs_on_ranks_on_the_cpu(smoke, tmp_path):
    """The online phase on 2 ranks: the managed stack's capture server
    sharded over 2 gloo ranks (``capture_shard_devices``) and the consumer
    as 2 ranks (``training.fsdp_size`` 2); the server's features still the
    runner's bit for bit, every rank of the server stopped, and the online
    step-1 loss the offline run's over the micro-batches' rows in rank
    order."""
    cfg = Eagle3Config(vocab_size=2048, draft_vocab_size=512, hidden_size=128,
                       intermediate_size=384, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=4096)
    cfg_path = tmp_path / "draft.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    target = smoke.write_capture_target(
        tmp_path / "target", {**smoke.QWEN3_8B_TARGET, **TINY_TARGET},
        torch.device("cpu"), 0, 0.2)
    results = smoke.online_phase(
        cfg_path, {"target": target, "vocab_mapping": None},
        tmp_path / "online", 0, torch.device("cpu"), max_length=64,
        min_len=40, ranks=2)
    assert results["supervisor_rc"] == 0 and results["ranks"] == 2
    assert sorted(r["capture_rank"] for r in results["server_ranks"]) == [
        0, 1]
    assert results["ledger"] == {"durable_step": smoke.ONLINE_STEPS,
                                 "acked": smoke.ONLINE_PROMPTS}
    assert results["features"]["bit_identical"]
    assert results["step1_loss"]["rel_diff"] <= smoke.TRAIN_STEP1_RTOL


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


#: the MoE capture's target cut to the CPU: DeepSeek-V2-Lite's layout (no
#: q LoRA, greedy softmax routing, a dense first layer) at the tiny draft's
#: width, 4 layers, 8 routed experts
TINY_MOE_TARGET = dict(vocab_size=2048, hidden_size=128,
                       intermediate_size=256, moe_intermediate_size=32,
                       num_hidden_layers=4, num_attention_heads=4,
                       num_key_value_heads=4, kv_lora_rank=32,
                       qk_nope_head_dim=32, qk_rope_head_dim=16,
                       v_head_dim=32, n_routed_experts=8,
                       num_experts_per_tok=2, n_shared_experts=1)


@pytest.mark.parametrize("name", ["llama3_70b", "qwen2_5_vl_7b",
                                  "deepseek_v2_lite"])
def test_offline_leftovers_run_on_the_cpu_at_small_size(smoke, tmp_path,
                                                       monkeypatch, name):
    """The offline_leftovers phase: each draft of ``LEFTOVER_RUNS`` cut to
    hidden 128 with its own RoPE type (llama3, mrope on [3, S] position ids
    over a vision span, yarn) and its layout of heads, through cli train
    (Llama: reference ``.ckpt`` features, two gzipped, and a warm start
    from an export written by the phase; DeepSeek-V2-Lite: features the
    MoE capture takes from its target first), the kernel-path trainer (its
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
    captured = None
    if name == "deepseek_v2_lite":
        # slice 17: the draft trains on features captured from a
        # DeepSeek-V2-shaped MoE target (MLA, 8 routed and a shared
        # expert), through the MoE capture's checks
        capture, captured = smoke.capture_phase(
            cfg_path, torch.device("cpu"), 0, tmp_path / "work",
            target_config={**smoke.DEEPSEEK_V2_LITE_TARGET,
                           **TINY_MOE_TARGET},
            n_train=spec["files"], n_eval=0, max_length=64, min_len=40,
            std=0.2, shard_layers=smoke.MOE_SHARD_LAYERS)
        assert capture["capture_layers"] == [1, 1, 0]
        assert capture["files_checked"] == spec["files"]
        assert len(list((tmp_path / "work" / "target").glob(
            "*.safetensors"))) == 3
        assert capture["moe_impl"] == "gathered"
        moe = capture["dense_vs_gathered"]
        assert set(moe["layers_alone_max_abs_err"]) == {
            "layer_1", "layer_2", "layer_3"}
        # fp32 on the CPU: the whole forward routes alike through both
        assert set(moe["whole_route_agreement"].values()) == {1.0}
        for agreement in (capture["bf16_vs_fp32_route_agreement"],
                          capture["alone_vs_batch_route_agreement"]):
            assert set(agreement) == {"layer_1", "layer_2", "layer_3"}
    results, counts = smoke.run_leftover(
        spec, torch.device("cpu"), 0, tmp_path / "work", max_length=64,
        min_len=40, head_std=0.2, overrides=['model.compute_dtype="float32"'],
        captured=captured)
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


def test_target_families_phase_runs_on_the_cpu(smoke):
    """The target_families phase with the CPU standing in for the card:
    every family of the CPU parity tests, both impls of each MoE family."""
    results = smoke.target_families_phase(0, torch.device("cpu"))
    assert set(results) == set(smoke.TINY_FAMILIES)
    for family, errors in results.items():
        assert errors["cuda_vs_cpu"] == 0.0
        assert ("dense_vs_gathered" in errors) == (
            family in smoke.MOE_FAMILIES)


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


def test_capture_mesh_phase_runs_on_the_cpu_at_small_size(smoke, tmp_path):
    """The capture-mesh phase: 2 ranks (``chip_smoke.py
    --capture-mesh-rank``, gloo on the CPU) started once for a dense
    target (bf16, leaves large enough to be cut) and an MoE target in
    DeepSeek-V2-Lite's layout under EP, held against one process's
    references (``save_capture_reference``), which are written after the
    ranks start, as the default run starts them before the MoE capture:
    the dense features bit for bit, the EP capture within its bounds, the
    fp32 layer alone, the abort at the overflowing factor; each rank holds
    fewer bytes."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 2048, size=(2, 32))
    mask = np.ones_like(ids)
    mask[1, 20:] = 0
    ids = ids * mask
    runs = [{"name": name, "target": str(tmp_path / name),
             "ref": str(tmp_path / f"{name}.pt")}
            for name in ("dense_fsdp", "moe_ep")]
    launched = smoke.launch_capture_mesh(runs, tmp_path / "work", cpu)
    for name, config, layers in (
            ("dense_fsdp", dict(smoke.QWEN3_8B_TARGET, vocab_size=2048,
                                hidden_size=256, intermediate_size=512,
                                num_hidden_layers=3, num_attention_heads=4,
                                num_key_value_heads=2, head_dim=64),
             (0, 1, 2)),
            ("moe_ep", dict(smoke.DEEPSEEK_V2_LITE_TARGET,
                            **TINY_MOE_TARGET), (1, 2, 3))):
        target = smoke.write_capture_target(tmp_path / name, config, cpu, 0,
                                            smoke.TARGET_STD, 1)
        runner = smoke.OfflineCaptureRunner(smoke.OfflineCaptureConfig(
            str(target), str(tmp_path / "unused"), layers, 32, 2),
            device=cpu)
        smoke.save_capture_reference(runner, ids, mask,
                                     tmp_path / f"{name}.pt")
    results = smoke.finish_capture_mesh(launched)
    assert results["transport"] == "gloo" and results["ranks"] == 2
    dense, moe = results["dense_fsdp"], results["moe_ep"]
    assert all(r["aux_bit_identical"] and r["last_bit_identical"]
               for r in dense)
    assert all(r["gathered_bytes_per_forward"] > 0 for r in dense)
    assert all(r["embed_rows_bytes"] < r["embed_whole_bytes"] for r in dense)
    assert all(r["overflow"] == 0 for r in moe)
    assert all(r["overflow_abort"].startswith("EP MoE capacity overflow")
               for r in moe)


def test_capture_mesh_only_runs_on_the_cpu_at_small_size(smoke,
                                                         monkeypatch):
    """``--capture-mesh-only`` with its targets cut to the CPU: the dense
    target at ``LLAMA_MESH_DEPTH`` layers against one process over a cut
    of its first ``LLAMA_REF_DEPTH`` (linked shards, no bytes copied), the
    MoE target under EP at all its layers, 2 gloo ranks each."""
    monkeypatch.setattr(smoke, "emit", lambda obj: None)
    dense = dict(smoke.LLAMA3_70B_TARGET, vocab_size=2048, hidden_size=256,
                 intermediate_size=512, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=64)
    moe = dict(smoke.DEEPSEEK_V2_LITE_TARGET, **TINY_MOE_TARGET)
    results = smoke.capture_mesh_only_phase(
        0, torch.device("cpu"), dense=dense, moe=moe, batch=2, min_len=32,
        max_length=64, ranks=2)
    assert results["dense"]["depth"] == smoke.LLAMA_MESH_DEPTH
    assert all(r["aux_bit_identical"] and "last_bit_identical" not in r
               for r in results["dense"]["dense_fsdp"])
    assert all(r["overflow"] == 0 for r in results["moe"]["moe_ep"])


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
