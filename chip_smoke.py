#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

Usage: ``python3 chip_smoke.py [--seed N]`` from the repository root.
``python3 chip_smoke.py --usp-only`` runs phases 1, 2 and 8's training
alone, ``--mesh-only`` phases 1, 2 and 9 (on a machine with a card per
rank their ranks talk NCCL), ``--leftovers-only`` phases 1, 2 and 10's
training runs (with 10a), ``--capture-only`` phases 1, 2, 5a, 5, 5d, 5b
and 10a with its training run (the captures at all 36 and all 27 target
layers, training, export, serving, the families), ``--online-only``
phases 1, 2 and 5c, its target at all 36 layers, ``--serving-gaps``
phase 1 and the study behind ``SERVING_TIE_ULPS`` (``serving_gaps``:
bf16 greedy decoding against the verify block, sound and with planted
faults, and the chain and plain decoders against greedy, on random
targets at all 36 layers of Qwen3-8B).

Phases, each printing JSON lines:

1. device facts: torch/CUDA versions, ``nvidia-smi`` name and power limit,
   the ``nvcc`` version;
2. build: every kernel source of ``specforge_tpu_torch/csrc`` compiled by
   ``nvcc`` for ``sm_90a`` (in parallel) into one library;
3. kernels, at the shapes of the slices: each kernel (the TTT attention and
   fused CE forwards, the fused CE backward and the two TTT attention
   backward kernels; the DFlash block-attention forward and its two
   backward kernels in cases (a)-(g) of ``DFLASH_CASES``, (f) and (g) at
   blocks of 7; the COD attention
   forward and its two backward kernels in cases (a)-(e) of
   ``COD_CASES``; the LSE ring-hop forward and its two backward kernels in
   cases (a)-(e) of ``LSE_CASES``; the TTT forward and backward also at
   the head layouts of ``HEAD_LAYOUTS``, the GQA groups of 8, 7 and 1 of
   phase 10's drafts) is held against
   its plain PyTorch version on the card, in the working dtype, and timed
   with CUDA events (median of 20 runs after 3 warm-ups) beside the plain
   version, one PyTorch library call as a yardstick, and its bound (the
   two TTT backward kernels also beside the whole ``ttt_flash_attention_bwd``
   they make up, ``whole_bwd_ms``); the TTT forward also on a batch row
   with no valid key (out 0, m = -1e30, l = 0 exactly), twice at the main
   shape with the same bits, and beside a second, timed-only yardstick,
   the library flash kernel over the causal block alone
   (``library_causal_ms``); the DFlash, COD and LSE kernels (forward, dq
   and dk/dv) also twice in every case for the same bits, the forward's
   rows with no allowed key (DFlash: rows of blocks not kept) exactly out
   0, m (or lse) -1e30 and l 0, dq exactly 0 on those rows and dk/dv on
   keys no row reaches, and every
   DFlash, COD and LSE kernel 30 launches back to back (``run_ms``); the
   LSE kernels also beside the library flash kernel over the same pairs
   where it takes them without a mask (``library_flash_ms``: causal for an
   own hop, unmasked for an earlier one);
4. slice 1: the EAGLE3 offline TTT forward at the full Qwen3-8B EAGLE3 width
   (``configs/qwen3-8b-eagle3.json``, random weights from ``--seed``), from
   feature files written and read back by the port's data plane, through
   ``Evaluator.run`` and ``Eagle3TrainStrategy.forward_loss`` with the
   compact teacher; the kernel launch counters must show 7 launches of each
   forward kernel per forward, and the metrics must agree with the same
   batches run through the plain dense attention and reference CE;
5a. slice 16, capture (``capture``): a random target in the shape of
   Qwen3-8B (``QWEN3_8B_TARGET``: 36 layers, 8.2 B parameters, 16.4 GB
   bf16 from ``--seed``; ``CAPTURE_DEPTH`` layers in the default run)
   written as an HF directory of safetensors shards with an index by the
   port's writer; conversations from the seed (1536-2048 tokens, words
   from a synthetic lexicon) rendered by the port's ``qwen`` template and
   parser (``build_dataset``) with a stand-in tokenizer whose ids spread
   over the whole vocabulary; the eagle layout captured at the draft's
   default layers ((1, 17, 32) at 36) through the port's loader and
   runner (``prepare.capture``) into phase 5's train and eval
   directories, and the vocab mapping derived from the captured ids;
   every captured tensor finite, the files read back through the data
   plane in the right shapes with the parser's ids and loss masks, a
   sample captured alone against its row of a padded batch and one
   batch's bf16 capture against an fp32 run of the same forward
   (``CAPTURE_REL_L2``); the load and capture seconds, tokens/s and peak
   memory;
5. slice 2, training: ``specforge_tpu_torch.cli.main(["train", ...])`` on
   ``examples/qwen3-8b-eagle3-offline.json`` pointed at phase 5a's
   captured features, its target (whose head and embedding the trainer
   reads) and its vocab mapping, for 2 optimizer steps of
   2 micro-batches (B=2, S=2048, TTT 7, compact teacher), with an eval and
   checkpoints; exactly 7 launches of every kernel per micro-batch (and of
   the forward kernels per eval forward); the kernel path against the plain
   path (dense attention, reference CE) from the same initial weights; a
   resume from the step-1 checkpoint that must reach the same weights; the
   micro-step and optimizer-step times of the trainer's own train step,
   peak memory with and without ``compute_params_dtype``, one profiled
   micro-step, and a warm start from the step-1 checkpoint (phase 10);
   slice 16's export (``check_exports``): ``cli.main(["export", ...])`` of
   the run's final checkpoint to the SGLang layout and ``export_to_hf``
   with the target as ``embedding_source``, their required keys and
   ``config.json``, every weight read back through
   ``draft_state_from_export`` bit-identical to the checkpoint's cast to
   bf16 and the HF embedding the target's;
5d. slice 19, chain speculative serving (``serving``): phase 5a's target
   (``CAPTURE_DEPTH`` layers) and phase 5's SGLang export through the
   serving loaders into the chain decoder (``k`` = 4, ``max_len`` 2048),
   on 4 prompts of 256-1024 tokens cut from the eval conversations, 64 new
   tokens each: in fp32 with no TF32, ``greedy_target_decode``,
   ``fused_plain_decode``, ``generate`` and ``generate_fused`` emit the
   same tokens, the two chain paths the same accept lengths; in bf16 the
   prefill ms, rounds/s and tokens/s of ``generate_fused`` (a CUDA graph a
   round) against ``fused_plain_decode`` (a graph a token), the mean
   accept length, graph replays equal to the rounds and token steps, peak
   memory, the agreement with greedy decoding (every token held to
   greedy's step along the decoder's own output: at most
   ``SERVING_TIE_ULPS`` bf16 ulps below its top-1) and one round's device
   ops under torch.profiler; and
   ``python -m specforge_tpu_torch.inference.serving_server_main`` as a
   process on the same files, its ``/health`` and a chain and a ``plain``
   ``/generate`` equal to this process's decoder;
5c. slice 18, the online runtime (``online``): ``python -m
   specforge_tpu_torch.cli train -c examples/qwen3-8b-eagle3-online.json
   --managed-local`` with its paths, ports and steps overridden, so the
   port's launch plan starts the store server the build phase made, a
   capture server holding phase 5a's target (``CAPTURE_DEPTH`` layers) on
   the card, the producer (8 tokenised prompts of 1536-2048 tokens from
   the seed) and the consumer, which trains ``configs/qwen3-8b-eagle3.json``
   for 2 steps of 2 micro-batches of 2; beside the stack this process asks
   the server for the producer's batches with the ``inline`` sink. Checks:
   the supervisor exits 0 (so do the producer and consumer), the server
   ran on the card, 7 launches of every TTT and fused CE kernel a
   micro-batch in the consumer (its jsonl tracker's ``perf/launches``), 0
   objects left in the store and the ledger's durable step 2, the first
   batch's features bit-identical to ``OfflineCaptureRunner._run_batch``
   here at the same padded shape, and the online step-1 loss within
   ``TRAIN_STEP1_RTOL`` of an offline ``cli train`` run over the same
   features in the inbox's order; the server's time to ready, the
   producer's samples/s, the store's bytes, the consumer's step times and
   both processes' peak memory;
5b. slice 17, the target families (``target_families``): each tiny
   target of ``tests/_torch_targets.TINY_FAMILIES`` (gemma3, phi3,
   gpt-oss, deepseek v2 (greedy and group-limited), v3, kimi_k2, glm4_moe,
   llama4, qwen3_next, longcat_flash, the Qwen2.5-VL text tower,
   qwen3_moe; written from the seed) through the port's fp32 capture
   forward on the card against the same forward on the CPU, and each MoE
   family's ``moe_impl="dense"`` against ``gathered`` on the card, with no
   TF32, within ``MOE_IMPL_TOL`` and with the same routing;
6. slice 3, the DFlash family: ``cli.main(["train", ...])`` on
   ``examples/qwen3-8b-domino-offline.json`` with ``configs/qwen3-8b-domino.json``
   at full width (B=2, S up to 768, 256 anchors of 16; accumulation 2, so 4
   optimizer steps and one checkpoint at the epoch's end): exactly 5
   launches of each DFlash kernel per micro-batch, the kernel path against
   the chunked plain path (the draft config's ``attention_backend:
   "chunked"``) from the same initial weights and anchors, ``lambda_base``
   decaying as ``linear_lambda_base`` says, the micro-step and optimizer
   times, peak memory and one profiled micro-step; then one optimizer step
   of the ``dflash`` strategy on ``configs/qwen3-8b-dflash.json`` (512
   anchors, the ``loss_terms`` normalisation) against its plain path;
   then DSpark (``dspark_training``): the same ``cli train`` run with the
   ``dspark`` strategy on ``configs/qwen3-8b-dspark.json`` (a gated Markov
   head of rank 64 and a confidence head; the feature files also carry
   ``target_last_hidden_states``), 5 launches of each DFlash kernel per
   micro-batch, the kernel path against the chunked plain path, all nine
   ratio metrics finite, the timings, peak memory and one profiled
   micro-step; and one optimizer step at ``configs/qwen3-4b-dspark.json``
   (``dspark_block7_training``: blocks of 7, so the kernels' pitch of 8; a
   vanilla Markov head of rank 256, a confidence head with Markov, its
   own random target [151936, 2560]) against its plain path, its launches
   counted;
7. slice 4, P-EAGLE: the three COD attention kernels against their plain
   versions in cases (a)-(e) of ``COD_CASES`` (among the kernels of phase
   3); then ``cli.main(["train", ...])`` on
   ``examples/qwen3-8b-peagle-single-chip.json`` with
   ``configs/qwen3-8b-peagle.json`` at full width (B=2, S up to 1024, 8
   depths, so T=3456 sampled rows; factored moments, ``adam_b1`` 0, bf16
   moments, the row-sparse embedding update; accumulation 2, so 2
   optimizer steps): exactly 4 launches of each COD kernel and 1 of each
   fused CE kernel per micro-batch, a second run and a resume from the
   step-1 checkpoint that reach the same weights bit-exactly, the dense
   embedding update against the row-sparse one, the kernel path against
   the dense plain path from the same weights and samples, the timings,
   peak memory and one profiled micro-step, and one optimizer step over
   packed rows (``data.pack_documents``, 4 documents to a row);
8. slice 5, USP sequence parallelism: the three offset-causal LSE
   ring-hop kernels against their plain versions in cases (a)-(e) of
   ``LSE_CASES`` and at the USP phase's three hops (among the kernels of
   phase 3); then
   ``cli.main(["train", ...])`` on ``examples/qwen3-8b-eagle3-usp-32k.json``
   with ``configs/qwen3-8b-eagle3.json`` at full width on 4 ranks of a 2×2
   grid started as processes with the SPECFORGE_* env (``--usp-rank``),
   sharing one card over host-staged gloo, or over NCCL with a card each
   where the machine has four (B=1, S=4096, TTT 7, compact
   teacher; accumulation 2, so 2 optimizer steps, checkpoints at steps 1
   and 2): 14 launches of each LSE kernel and 7 of each fused CE kernel per
   micro-batch on every rank and none of the TTT kernels, the same losses
   and bit-identical weights on every rank, only rank 0 writing, a 4-rank
   resume from step 1 that reaches the final weights bit-exactly (on one
   shared card: steps of one micro-batch, a checkpoint at the end, no
   resume), and the USP run against one process on the TTT kernels over
   the same batches and weights; the transport, per-rank timings,
   collectives' share and memory beside the single process's;
9. slice 14, data parallelism and fsdp: ``cli.main(["train", ...])`` on 4
   ranks (``--mesh-rank``) for each run of ``MESH_RUNS``, in one launch:
   EAGLE3 at dp 2 × fsdp 2 (``examples/qwen3-8b-eagle3-offline.json``,
   global batch 4 at S 2048, accumulation 2, 4 optimizer steps, eval,
   checkpoints at steps 2 and 4, a 4-rank resume from step 2 that reaches
   the final weights bit-exactly; on one shared card 2 steps of one
   micro-batch, a checkpoint at the end and a 4-rank restore of it that
   gives the final weights bit-exactly), P-EAGLE at fsdp 4
   (factored Adam, the row-sparse embedding), Domino at dp 2 × fsdp 2 and
   EAGLE3 under USP at fsdp 2 × sp_ring 2 (not on one shared card), a step
   each;
   the launches of every kernel on every rank, the same losses and
   bit-identical whole weights on every rank, only rank 0 writing, each
   run against one process of the same global batch (losses; EAGLE3's
   step-1 gradients), the bytes of a rank's masters and moments against
   one process's, and per rank the whole-step and collectives' times (and
   a micro-step's, not on one shared card) and memory;
10. slice 15, the offline leftovers (``offline_leftovers``): for each draft
   of ``LEFTOVER_RUNS`` at full width, ``cli.main(["train", ...])`` on
   ``examples/qwen3-8b-eagle3-offline.json`` (B=2, S=2048, TTT 7, compact
   teacher) with exactly 7 launches of every TTT and fused CE kernel per
   micro-batch; then a kernel-path trainer whose step-1 loss and gradients
   repeat bit for bit and equal the ``cli`` run's step-1 loss, and the
   plain path (the chunked dense attention, reference CE) from the same
   weights at step 1. ``configs/llama3-70b-eagle3.json`` (llama3 RoPE, 64
   heads over 8): 2 steps of 2 micro-batches from reference ``.ckpt``
   features (two gzipped), warm-started from a ``model.safetensors`` in the
   SGLang export layout written here by the exporter's ``serving_state``
   (the loaded weights bit-identical to the file's), with the micro-step,
   optimizer-step, memory and a
   profiled micro-step; ``configs/qwen2.5-vl-7b-eagle3.json`` (mrope over
   [3, S] position ids of a vision span) and
   ``configs/deepseek-v2-lite-eagle3.json`` (yarn), a step each, the
   DeepSeek draft on the features of 10a (one step of 2 micro-batches);
   and phase 5's warm start from its own step-1 directory (the masters
   bit-identical to the saved ones, a fresh optimizer);
10a. slice 17, the MoE capture (``capture_moe``): phase 5a's capture from
   a random target in the shape of DeepSeek-V2-Lite
   (``DEEPSEEK_V2_LITE_TARGET``: MLA, 64 routed experts of which 6 a
   token and 2 shared, the first layer dense; 27 layers, 15.7 B
   parameters, 31.4 GB bf16; ``MOE_CAPTURE_DEPTH`` layers in the default
   run), one padded batch of 4 conversations through the runner with
   ``moe_impl="gathered"``, with phase 5a's checks and three of its own:
   each MoE layer's routing in the bf16 run and in the sample alone
   agreeing with the fp32 run's and the batch's on at least
   ``MOE_ROUTE_AGREEMENT`` of the assignments, and each MoE layer of the
   fp32 batch alone, fed the same input, through ``moe_impl="dense"`` and
   ``gathered``: routed identically and within ``MOE_IMPL_TOL`` (the whole
   forward through both is reported);
11. the kernels line, then the card line, then ``{"ok": true, ...}``.

Phases 9 and 8's training run right after the build, before the kernel
phases: their 4 ranks need most of the card's memory, and this process
holds none of it yet; the LSE kernels are held against their plain
versions in phase 3.

Any failed check raises: the script then exits non-zero with a traceback and
prints no result. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import gzip
import hashlib
import importlib.util
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from specforge_tpu_torch import cli
from specforge_tpu_torch.algorithms.eagle3.model import OnlineEagle3Model
from specforge_tpu_torch.algorithms.peagle.model import (
    doc_major,
    document_ids_from_lengths,
    generate_cod_sample_indices,
)
from specforge_tpu_torch.algorithms.builtin import builtin_algorithm_registry
from specforge_tpu_torch.application.composition import build_training_run
from specforge_tpu_torch.config.schema import load_config
from specforge_tpu_torch.data.collator import CollatorConfig, PaddingCollator
from specforge_tpu_torch.data.parse import (
    build_dataset,
    build_parser_for_template,
)
from specforge_tpu_torch.data.vlm import mrope_position_ids, spans_from_token_ids
from specforge_tpu_torch.eval.evaluator import Evaluator
from specforge_tpu_torch.export import exporter
from specforge_tpu_torch.export.exporter import (
    REQUIRED_SGLANG_KEYS,
    export_to_hf,
    serving_state,
)
from specforge_tpu_torch.models.model_loading import draft_state_from_export
from specforge_tpu_torch.models.draft.dflash import (
    DFlashConfig,
    build_target_layer_ids,
)
from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    LlamaEagle3Draft,
)
from specforge_tpu_torch.models.draft.peagle import PEagleConfig, cod_capacities
from specforge_tpu_torch.inference import spec_decode
from specforge_tpu_torch.inference.serving_loaders import (
    DFLASH_DRAFTS,
    build_decoder,
    load_exported_draft,
    load_spec_models,
)
from specforge_tpu_torch.models.target.head import TargetHead
from specforge_tpu_torch.models.target.transformer import (
    TargetConfig,
    load_target_params,
    target_capture_forward,
)
from specforge_tpu_torch.offline_capture import prepare
from specforge_tpu_torch.offline_capture.capture import (
    OfflineCaptureConfig,
    OfflineCaptureRunner,
)
from specforge_tpu_torch.ops import (
    attention_cuda,
    cuda_lib,
    dflash_attention_cuda,
    loss_cuda,
    lse_attention_cuda,
    peagle_attention_cuda,
)
from specforge_tpu_torch.ops.loss import log_softmax_loss_reference
from specforge_tpu_torch.ops.masks import (
    dflash_dense_mask,
    sample_anchor_positions,
)
from specforge_tpu_torch.parallel.fsdp import state_bytes
from specforge_tpu_torch.runtime.data_plane.feature_dataloader import (
    FeatureDataLoader,
)
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    load_feature_file,
    read_feature_specs,
    save_feature_file,
)
from specforge_tpu_torch.runtime.data_plane.feature_store import FileFeatureStore
from specforge_tpu_torch.runtime.data_plane.offline_reader import (
    OfflineManifestReader,
)
from specforge_tpu_torch.training.checkpoint import CheckpointManager
from specforge_tpu_torch.training.strategies import (
    Eagle3TrainStrategy,
    linear_lambda_base,
)
from specforge_tpu_torch.training.train_step import make_train_step
from specforge_tpu_torch.training.vocab_mapping import (
    load_vocab_mapping,
    save_vocab_mapping,
)

REPO = Path(__file__).resolve().parent


def _repo_module(relpath: str):
    """A module of the repository loaded from its file (a package named
    ``tests`` installed elsewhere would shadow the repository's)."""
    spec = importlib.util.spec_from_file_location(Path(relpath).stem,
                                                  REPO / relpath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: the target families' tensors and tiny checkpoints (slice 17)
_targets = _repo_module("tests/_torch_targets.py")
MOE_FAMILIES, TINY_FAMILIES = _targets.MOE_FAMILIES, _targets.TINY_FAMILIES
layer_shapes, tensor_shapes = _targets.layer_shapes, _targets.tensor_shapes
write_family_target = _targets.write_family_target
CONFIG = REPO / "configs" / "qwen3-8b-eagle3.json"
EXAMPLE = REPO / "examples" / "qwen3-8b-eagle3-offline.json"

# published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet)
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12

# slice shapes: examples/qwen3-8b-eagle3-offline.json
BATCH, MAX_LEN, TTT = 2, 2048, 7
N_FILES = 8
ATTN_TOL = 2e-2   # bf16 output: relative eps 7.8e-3, sums in another order
STAT_RTOL = 1e-3  # fp32 row statistics from bf16 products
CE_RTOL = 1e-4    # fp32 sums over 32000 in another order
SLICE_RTOL = 1e-2  # bf16 activations: the kernel and the dense path round
                   # attention probabilities and outputs at other places
# bf16 attention gradients: products of bf16-rounded p and ds (relative eps
# 7.8e-3), summed over up to 2048 keys in another order; held at 2e-2 of the
# largest reference value
ATTN_BWD_RTOL = 2e-2
# fused CE gradient against the plain fp32 one rounded to the logits' dtype,
# per element: CE_BWD_RTOL of |ref| for two bf16 roundings of fp32 values
# that differ in their last bits (one bf16 step is at most 7.8e-3 of the
# value), plus CE_BWD_TERM_RTOL of the two terms the gradient is the
# difference of, for the fp32 rounding (``__expf``, about 2e-6 here) where
# they cancel
CE_BWD_RTOL = 1e-2
CE_BWD_TERM_RTOL = 1e-5
CE_BWD_TOL = (f"{CE_BWD_RTOL} * |ref| + {CE_BWD_TERM_RTOL} * "
              "(|t| + softmax * |ts|) * |g| / (B*T) * mask")
# training, kernel path vs plain path (both bf16): step 1 is taken before any
# update; later steps drift apart over Adam steps, since bf16 paths that
# round at other places feed slightly different gradients to the moments
TRAIN_STEP1_RTOL = 1e-2
TRAIN_DRIFT_RTOL = 5e-2
GRAD_COSINE = 0.99
GRAD_NORM_RTOL = 2e-2
# the training slice: examples/qwen3-8b-eagle3-offline.json, cut to 2
# optimizer steps of 2 micro-batches (4 before the mesh phase joined the
# script)
TRAIN_FILES, EVAL_FILES, ACCUM = 8, 4, 2
#: reference features gzipped (level 1): the first files
GZ_FILES = 2
#: Qwen2.5-VL's image token, and the vision span of a sample (one image of
#: 16 x 16 merged patches)
IMAGE_TOKEN_ID = 151655
VISION_GRID = (1, 16, 16)


#: the script's start, for each phase line's ``elapsed_s``, and the time of
#: the last phase line, for its ``phase_s`` (the seconds since the line
#: before it: the phase's own)
START = time.perf_counter()
_LAST_LINE = [START]


def emit(obj) -> None:
    if "phase" in obj:
        now = time.perf_counter()
        obj = {**obj, "elapsed_s": now - START,
               "phase_s": now - _LAST_LINE[0]}
        _LAST_LINE[0] = now
    print(json.dumps(obj), flush=True)


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(fn, launches: int = 30, warmup: int = 3) -> float:
    """ms a launch over ``launches`` launches back to back between two
    events, after ``warmup``: the kernel as a step runs it, with no sync
    between launches (median_ms syncs after each, so its times include
    the wrapper's host work before the launch)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def check_repeat(name: str, fn) -> None:
    """Two launches of ``fn`` give the same bits in every output."""
    first, second = fn(), fn()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two launches differ")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} over tolerance {tol}")


def device_facts() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [cuda_lib.nvcc_path(), "--version"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[-1]
    emit({
        "phase": "device",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvidia_smi": smi,
        "nvcc": nvcc,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    })
    return smi


#: the kernels redesigned for Hopper whose ptxas report the build line
#: details; a wgmma serialization note (C75xx) fails the build phase
HOPPER_KERNELS = ("ttt_fwd_kernel", "ttt_bwd_dq_kernel", "ttt_bwd_dkv_kernel",
                  "dflash_fwd_kernel", "dflash_bwd_dq_kernel",
                  "dflash_bwd_dkv_kernel",
                  "cod_fwd_kernel", "cod_bwd_dq_kernel", "cod_bwd_dkv_kernel",
                  "lse_fwd_kernel", "lse_bwd_dq_kernel", "lse_bwd_dkv_kernel")
#: the kernels line's entries whose kernel is one of HOPPER_KERNELS, with
#: the route note they carry (every attention kernel; the fused CE kernels
#: are not warp-specialised)
HOPPER_ROUTE = ("ttt_flash_attention_fwd", "ttt_attention_bwd_dq",
                "ttt_attention_bwd_dkv", "dflash_attention_fwd",
                "dflash_attention_bwd_dq",
                "dflash_attention_bwd_dkv", "cod_attention_fwd",
                "cod_attention_bwd_dq", "cod_attention_bwd_dkv",
                "lse_attention_fwd", "lse_attention_bwd_dq",
                "lse_attention_bwd_dkv")


def ptxas_report(log: str) -> tuple:
    """ptxas's registers and spills per entry function of HOPPER_KERNELS
    (keyed by kernel and head dim, and ``, true`` for a build with its bool
    template flag set: the DFlash kernels' pitched builds) and every wgmma
    serialization note → (report, notes)."""
    report, notes, current = {}, [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = found.group(1)
            kernel = next((k for k in HOPPER_KERNELS if k in name), None)
            args = re.search(r"ILi(\d+)E(Lb([01])E)?", name)
            flag = ", true" if args and args.group(3) == "1" else ""
            current = (f"{kernel}<{args.group(1) if args else '?'}{flag}>"
                       if kernel else None)
        if re.search(r"\bC75\d\d\b", line) or "serialized" in line:
            notes.append(line.strip())
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            report.setdefault(current, {}).update(
                spill_stores=int(spill.group(1)),
                spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            report.setdefault(current, {})["registers"] = int(regs.group(1))
    return report, notes


def build() -> None:
    """The kernel library, and beside it the feature store server
    (``g++``, in a thread) the online phase's stack runs."""
    from specforge_tpu_torch.runtime.data_plane import network_store

    t0 = time.perf_counter()
    store = {}

    def build_store():
        t = time.perf_counter()
        try:
            store["path"] = str(network_store.server_binary())
        except BaseException as exc:  # noqa: BLE001 — raised below
            store["error"] = exc
        store["seconds"] = time.perf_counter() - t

    store_thread = threading.Thread(target=build_store)
    store_thread.start()
    cuda_lib.library()
    store_thread.join()
    if "error" in store:
        raise store["error"]
    log = cuda_lib.build_log or ""
    ptxas = [
        line.strip() for line in log.splitlines()
        if "registers" in line or "spill" in line
    ]
    report, notes = ptxas_report(log)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": cuda_lib.build_seconds,
          "sources": list(cuda_lib.SOURCES), "headers": list(cuda_lib.HEADERS),
          "hopper_kernels": report, "wgmma_serialization": notes,
          "store_server": str(Path(store["path"]).relative_to(REPO)),
          "store_server_seconds": store["seconds"], "ptxas": ptxas})
    if notes:
        raise AssertionError(f"ptxas serialized wgmma: {notes}")


# --------------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------------

#: query and kv heads of the TTT kernels' main path (Qwen3-8B, a group of
#: 4) and of the drafts ``offline_leftovers`` trains: Llama-3-70B (a group
#: of 8, two 4-head blocks), Qwen2.5-VL-7B (7: blocks of 4 and 3) and
#: DeepSeek-V2-Lite (1)
MAIN_HEADS = (32, 8)
HEAD_LAYOUTS = ((64, 8), (28, 4), (16, 16))


def attention_inputs(gen, s, n_branches, padded, heads=MAIN_HEADS):
    (h, kvh), b, d = heads, BATCH, 128
    dev, bf = "cuda", torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev, dtype=bf)

    q = rnd(b, h, s, d)
    keys = [rnd(b, kvh, s, d) for _ in range(n_branches + 1)]
    values = [rnd(b, kvh, s, d) for _ in range(n_branches + 1)]
    key_valid = torch.ones((b, s), dtype=torch.int32, device=dev)
    if padded:
        key_valid[1, s - 300:] = 0
    return q, keys, values, key_valid


def attention_bound_ms(q, keys, key_valid) -> dict:
    """The two terms of the least time for the same work: each input read
    once, each output written once; the FLOPs of the allowed (row, key)
    pairs of these inputs."""
    b, h, s, d = q.shape
    nbytes = (
        2 * q.numel() * 2                      # q in, out
        + sum(k.numel() for k in keys) * 2 * 2  # every key and value
        + key_valid.numel() * 4
        + 2 * b * h * s * 4                    # m, l
    )
    valid = (key_valid != 0).to(torch.int64)
    # allowed causal keys of row r: valid keys among 0..r
    pairs = int(valid.cumsum(dim=1).sum()) + b * s * (len(keys) - 1)
    flops = 4 * d * h * pairs                  # QK^T and PV
    return {"bytes_ms": nbytes / PEAK_HBM * 1e3,
            "ops_ms": flops / PEAK_BF16 * 1e3}


def sdpa_yardstick(q, keys, values, key_valid):
    """One library call computing the same function: SDPA over the keys
    concatenated as [k0, kb1..kbNB] with a mask that is causal (and
    key_valid) on k0 and diagonal on each branch. Timed only."""
    b, h, s, d = q.shape
    nb = len(keys) - 1
    k_cat = torch.cat(keys, dim=2)
    v_cat = torch.cat(values, dim=2)
    idx = torch.arange(s, device=q.device)
    causal = (idx[None, :] <= idx[:, None])[None] & (key_valid != 0)[:, None, :]
    eye = torch.eye(s, dtype=torch.bool, device=q.device).expand(b, s, s)
    mask = torch.cat([causal] + [eye] * nb, dim=2)[:, None]
    return lambda: F.scaled_dot_product_attention(
        q, k_cat, v_cat, attn_mask=mask, enable_gqa=True
    )


def sdpa_causal_yardstick(q, keys, values):
    """A second yardstick for the forward, timed only: one library flash
    kernel over the causal block alone (SDPA with ``is_causal``; k0 and v0
    repeated to the H query heads outside the timed call). It computes
    another function (no branches, no key_valid) and says where the causal
    block stands against a library flash kernel on this card → (ms, name of
    the SDPA backend that ran: flash, else the next fused one that takes
    these inputs)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    g = q.shape[1] // keys[0].shape[1]
    k = keys[0].repeat_interleave(g, dim=1)
    v = values[0].repeat_interleave(g, dim=1)
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        with sdpa_kernel(backend):
            try:
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
            except RuntimeError:
                continue
            return median_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)), backend.name
    raise RuntimeError("no fused SDPA backend takes the causal yardstick")


def attention_kernel_phase(gen) -> dict:
    fwd = attention_cuda.ttt_flash_attention_fwd
    plain = attention_cuda.ttt_flash_attention_plain
    worst = 0.0
    timed = []
    # (S, branches, padded key_valid, batch row 0 with no valid key)
    cases = [(MAX_LEN, nb, True, False) for nb in range(TTT)]
    cases += [(MAX_LEN, 0, False, False), (MAX_LEN, 6, False, False),
              (MAX_LEN - 1, 0, True, False), (MAX_LEN - 1, 6, True, False),
              (MAX_LEN, 0, False, True), (MAX_LEN, 2, True, True)]
    cases = [c + (MAIN_HEADS,) for c in cases]
    cases += [(MAX_LEN, nb, True, False, heads) for heads in HEAD_LAYOUTS
              for nb in (0, TTT - 1)]
    for s, nb, padded, empty, heads in cases:
        q, keys, values, key_valid = attention_inputs(gen, s, nb, padded,
                                                      heads)
        if empty:
            key_valid[0] = 0
        out, m, l = fwd(q, keys, values, key_valid)
        torch.cuda.synchronize()
        ref_out, ref_m, ref_l = plain(q, keys, values, key_valid)
        finite = all(bool(torch.isfinite(x).all()) for x in (out, m, l))
        check(f"ttt attention S={s} NB={nb} finite", 0.0 if finite else 1.0,
              0.0)
        err = max_err(out, ref_out)
        # rows that attend to something; the others must come out exactly as
        # the TPU kernel leaves them: out 0, m = -1e30, l = 0
        live = ref_m > attention_cuda.NEG_INF
        m_err = (max_err(m[live], ref_m[live])
                 / (1.0 + float(ref_m[live].abs().max())))
        l_err = float(((l - ref_l).abs() / ref_l.clamp(min=1e-30))[live].max())
        dead = ~live
        out_rows = out.view(q.shape[0], s, q.shape[1], -1).transpose(1, 2)
        dead_exact = (bool((out_rows[dead] == 0).all())
                      and bool((m[dead] == attention_cuda.NEG_INF).all())
                      and bool((l[dead] == 0).all()))
        check(f"ttt attention S={s} NB={nb} padded={padded} empty={empty} "
              f"heads={heads}", err, ATTN_TOL)
        check(f"ttt attention m S={s} NB={nb}", m_err, STAT_RTOL)
        check(f"ttt attention l S={s} NB={nb}", l_err, STAT_RTOL)
        check(f"ttt attention empty rows S={s} NB={nb} (out 0, m -1e30, l 0)",
              0.0 if dead_exact else 1.0, 0.0)
        worst = max(worst, err)
        row = {"phase": "kernel", "name": "ttt_flash_attention_fwd",
               "S": s, "branches": nb, "padded": padded,
               "empty_batch_row": empty, "heads": list(heads),
               "rows_with_no_key": int(dead.sum()),
               "max_abs_err": err, "m_rel_err": m_err, "l_rel_err": l_err,
               "tol": ATTN_TOL}
        if s == MAX_LEN and padded and not empty and heads == MAIN_HEADS:
            # the main path's seven launches: one per branch count 0..6
            row["ms"] = median_ms(lambda: fwd(q, keys, values, key_valid))
            row["plain_ms"] = median_ms(
                lambda: plain(q, keys, values, key_valid))
            row["library_ms"] = median_ms(
                sdpa_yardstick(q, keys, values, key_valid))
            row["bound"] = attention_bound_ms(q, keys, key_valid)
            if nb == TTT - 1:
                # two launches on the same inputs give the same bits
                again = fwd(q, keys, values, key_valid)
                row["repeat_bit_exact"] = all(
                    torch.equal(a, b) for a, b in zip(again, (out, m, l)))
                check("ttt attention repeat bit-exact",
                      0.0 if row["repeat_bit_exact"] else 1.0, 0.0)
                del again
            timed.append(row)
        if (s == MAX_LEN and nb == 0 and not padded and not empty
                and heads == MAIN_HEADS):
            row["library_causal_ms"], row["library_causal_backend"] = (
                sdpa_causal_yardstick(q, keys, values))
            causal = row
        emit(row)
        del q, keys, values, ref_out, out
    n = len(timed)
    bound_ms, bound_by = mean_bound([r["bound"] for r in timed])
    return {
        "name": "ttt_flash_attention_fwd",
        "route": "cuda",
        "source": "specforge_tpu_torch/csrc/ttt_attention.cu",
        "replaces": "specforge_tpu/ops/attention_pallas.py:97",
        "max_abs_err": worst,
        "tol": ATTN_TOL,
        # per launch, averaged over the main path's branch counts 0..6
        "ms": sum(r["ms"] for r in timed) / n,
        "plain_ms": sum(r["plain_ms"] for r in timed) / n,
        "library_ms": sum(r["library_ms"] for r in timed) / n,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "repeat_bit_exact": timed[-1]["repeat_bit_exact"],
        # timed only: SDPA over the causal block alone at NB = 0, unpadded
        # (another function), on the backend named
        "library_causal_ms": causal["library_causal_ms"],
        "library_causal_backend": causal["library_causal_backend"],
    }


def ce_kernel_phase(gen) -> dict:
    rows, v = BATCH * MAX_LEN, 32000
    dev = "cuda"
    logits = (torch.randn(rows, v, generator=gen, device=dev) * 2).to(
        torch.bfloat16).view(BATCH, MAX_LEN, v)
    target = torch.softmax(
        torch.randn(rows, v, generator=gen, device=dev) * 2, dim=-1
    ).view(BATCH, MAX_LEN, v)
    mask = (torch.rand(rows, generator=gen, device=dev) > 0.2).to(
        torch.int32).view(BATCH, MAX_LEN, 1)
    fwd, plain = loss_cuda.loss_forward, loss_cuda.loss_forward_plain

    loss, (m, d, ts, _) = fwd(logits, target, mask)
    torch.cuda.synchronize()
    ref, (ref_m, ref_d, ref_ts, _) = plain(logits, target, mask)
    err = abs(float(loss) - float(ref))
    rel = err / abs(float(ref))
    check("fused CE loss", rel, CE_RTOL)
    for name, a, r in (("m", m, ref_m), ("d", d, ref_d), ("ts", ts, ref_ts)):
        check(f"fused CE {name}",
              float(((a - r).abs() / r.abs().clamp(min=1e-30)).max()), CE_RTOL)

    flat_logits, flat_target = logits.view(rows, v), target.view(rows, v)
    flat_mask = mask.view(rows).float()

    def library():
        ce = F.cross_entropy(flat_logits.float(), flat_target, reduction="none")
        return (ce * flat_mask).sum() / rows

    check("cross_entropy yardstick", abs(float(library()) - float(ref))
          / abs(float(ref)), CE_RTOL)
    nbytes = rows * v * (2 + 4) + rows * 4 + 4 * rows * 4
    t_bytes = nbytes / PEAK_HBM
    t_ops = 6 * rows * v / PEAK_FP32  # max, exp, sum, two products, sum
    row = {
        "name": "fused_ce_fwd",
        "route": "cuda",
        "source": "specforge_tpu_torch/csrc/fused_ce.cu",
        "replaces": "specforge_tpu/ops/loss_pallas.py:44",
        "max_abs_err": err,
        "rel_err": rel,
        "tol": CE_RTOL,
        "ms": median_ms(lambda: fwd(logits, target, mask)),
        "plain_ms": median_ms(lambda: plain(logits, target, mask)),
        "library_ms": median_ms(library),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
    }
    emit({"phase": "kernel", "R": rows, "V": v, **row})
    return row


def rel_max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|."""
    return max_err(got, ref) / max(float(ref.float().abs().max()), 1e-30)


def attention_bwd_bounds(q, keys, key_valid) -> dict:
    """Least times of the two backward kernels for these inputs: each input
    read once and each output written once; tensor-core products over the
    allowed (row, key) pairs at the bf16 peak, the branch diagonals' fp32
    arithmetic at the fp32 peak."""
    b, h, s, d = q.shape
    kvh, nb = keys[0].shape[1], len(keys) - 1
    valid = (key_valid != 0).to(torch.int64)
    pairs = int(valid.cumsum(dim=1).sum())
    product = 2 * d * h * pairs                  # one causal product
    q_bytes = q.numel() * 2                      # q, dO, dq: [B, H, S, D]
    kv_bytes = b * kvh * s * d * 2               # one key or value tensor
    stat_bytes = 3 * b * h * s * 4 + key_valid.numel() * 4  # m, l, delta
    branch_fp32 = 8 * d * b * h * s * nb         # the diagonals' dots/updates
    # q, dO and dq; every key and value read; the branch dk/dv written once
    # at [B, KVH, S, D] (the function's outputs, whatever the kernel writes)
    dq_bytes = (3 * q_bytes + 2 * (nb + 1) * kv_bytes + stat_bytes
                + 2 * nb * kv_bytes)
    dkv_bytes = 2 * q_bytes + 4 * kv_bytes + stat_bytes

    def bound(nbytes, tensor_ops, fp32_ops):
        return {"bytes_ms": nbytes / PEAK_HBM * 1e3,
                "ops_ms": (tensor_ops / PEAK_BF16 + fp32_ops / PEAK_FP32)
                * 1e3}

    return {"dq": bound(dq_bytes, 3 * product, branch_fp32),
            "dkv": bound(dkv_bytes, 4 * product, 0)}


def mean_bound(terms: list) -> tuple:
    """Per-launch bound averaged over launches, from each launch's
    ``{"bytes_ms", "ops_ms"}`` → (mean of the per-launch bounds, what bounds
    that mean: the larger of the mean bytes time and the mean operations
    time)."""
    n = len(terms)
    mean = sum(max(t["bytes_ms"], t["ops_ms"]) for t in terms) / n
    by_bytes = sum(t["bytes_ms"] for t in terms) > sum(t["ops_ms"]
                                                       for t in terms)
    return mean, "bytes" if by_bytes else "operations"


def sdpa_backward_yardstick(q, keys, values, key_valid, dout):
    """The backward of one library call computing the same function (SDPA
    over [k0, kb...] with the masks of :func:`sdpa_yardstick`): every
    gradient, timed only."""
    b, h, s, d = q.shape
    nb = len(keys) - 1
    qr = q.detach().requires_grad_(True)
    k_cat = torch.cat(keys, dim=2).requires_grad_(True)
    v_cat = torch.cat(values, dim=2).requires_grad_(True)
    idx = torch.arange(s, device=q.device)
    causal = (idx[None, :] <= idx[:, None])[None] & (key_valid != 0)[:, None, :]
    eye = torch.eye(s, dtype=torch.bool, device=q.device).expand(b, s, s)
    mask = torch.cat([causal] + [eye] * nb, dim=2)[:, None]
    out = F.scaled_dot_product_attention(qr, k_cat, v_cat, attn_mask=mask,
                                         enable_gqa=True)
    do = dout.view(b, s, h, d).transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qr, k_cat, v_cat), do,
                                       retain_graph=True)


def attention_backward_phase(gen) -> list:
    """The two TTT backward kernels against the plain backward, at the main
    path's shapes (0..6 branches, padded key_valid; S=2047; unpadded), and
    at the head layouts of ``HEAD_LAYOUTS`` (0 and 6 branches)."""
    fwd = attention_cuda.ttt_flash_attention_fwd
    worst = {"dq": 0.0, "dkv": 0.0}
    timed = []
    cases = [(MAX_LEN, nb, True, MAIN_HEADS) for nb in range(TTT)]
    cases += [(MAX_LEN - 1, 0, True, MAIN_HEADS),
              (MAX_LEN - 1, 6, True, MAIN_HEADS),
              (MAX_LEN, 6, False, MAIN_HEADS)]
    cases += [(MAX_LEN, nb, True, heads) for heads in HEAD_LAYOUTS
              for nb in (0, TTT - 1)]
    for s, nb, padded, heads in cases:
        q, keys, values, key_valid = attention_inputs(gen, s, nb, padded,
                                                      heads)
        out, m, l = fwd(q, keys, values, key_valid)
        dout = torch.randn(out.shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        dq, dks, dvs = attention_cuda.ttt_flash_attention_bwd(
            q, keys, values, key_valid, out, m, l, dout)
        torch.cuda.synchronize()
        ref_dq, ref_dks, ref_dvs = (
            attention_cuda.ttt_flash_attention_backward_plain(
                q, keys, values, key_valid, out, m, l, dout))
        # dq and the branch dk/dv come from the dq kernel, the step-0 block's
        # dk/dv from the dk/dv kernel
        err = {
            "dq": max([rel_max_err(dq, ref_dq)]
                      + [rel_max_err(a, r) for a, r in
                         zip(dks[1:] + dvs[1:], ref_dks[1:] + ref_dvs[1:])]),
            "dkv": max(rel_max_err(dks[0], ref_dks[0]),
                       rel_max_err(dvs[0], ref_dvs[0])),
        }
        for name, e in err.items():
            check(f"ttt attention backward {name} S={s} NB={nb} "
                  f"padded={padded} heads={heads} (max|err| / max|ref|)", e,
                  ATTN_BWD_RTOL)
            worst[name] = max(worst[name], e)
        row = {"phase": "kernel", "name": "ttt_attention_bwd", "S": s,
               "branches": nb, "padded": padded, "heads": list(heads),
               "rel_err_dq": err["dq"],
               "rel_err_dkv": err["dkv"],
               "max_abs_err_dq": max_err(dq, ref_dq),
               "max_abs_err_dkv": max(max_err(dks[0], ref_dks[0]),
                                      max_err(dvs[0], ref_dvs[0])),
               "tol": f"{ATTN_BWD_RTOL} * max|ref|"}
        if s == MAX_LEN and padded and heads == MAIN_HEADS:
            valid = key_valid.to(torch.int32)
            delta = attention_cuda.backward_delta(out, dout, q.shape[1])
            args = (q, keys, values, valid, dout, m, l, delta)
            row["dq_ms"] = median_ms(
                lambda: attention_cuda.ttt_attention_bwd_dq(*args))
            row["dkv_ms"] = median_ms(
                lambda: attention_cuda.ttt_attention_bwd_dkv(*args))
            # the whole backward: delta, both kernels and any reduction
            row["bwd_ms"] = median_ms(
                lambda: attention_cuda.ttt_flash_attention_bwd(
                    q, keys, values, key_valid, out, m, l, dout))
            row["plain_ms"] = median_ms(
                lambda: attention_cuda.ttt_flash_attention_backward_plain(
                    q, keys, values, key_valid, out, m, l, dout))
            row["library_ms"] = median_ms(
                sdpa_backward_yardstick(q, keys, values, key_valid, dout))
            row["bound"] = attention_bwd_bounds(q, keys, key_valid)
            timed.append(row)
        emit(row)
        del q, keys, values, out, dq, dks, dvs, ref_dq, ref_dks, ref_dvs
    n = len(timed)

    def mean(key):
        return sum(r[key] for r in timed) / n

    common = {"route": "cuda",
              "source": "specforge_tpu_torch/csrc/ttt_attention.cu",
              "tol": f"{ATTN_BWD_RTOL} * max|ref|",
              # the plain backward and the library backward compute every
              # gradient at once; each stands beside both kernels, and
              # beside the whole ttt_flash_attention_bwd
              "plain_ms": mean("plain_ms"), "library_ms": mean("library_ms"),
              "whole_bwd_ms": mean("bwd_ms")}
    # per launch, averaged over the main path's branch counts 0..6
    out = []
    for kernel, line in (("dq", 222), ("dkv", 278)):
        bound_ms, bound_by = mean_bound([r["bound"][kernel] for r in timed])
        out.append({
            "name": f"ttt_attention_bwd_{kernel}",
            "replaces": f"specforge_tpu/ops/attention_pallas.py:{line}",
            "max_abs_err": max(r[f"max_abs_err_{kernel}"] for r in timed),
            "rel_err": worst[kernel], "ms": mean(f"{kernel}_ms"),
            "bound_ms": bound_ms, "bound_by": bound_by, **common})
    return out


def ce_backward_tolerance(logits, target, stats, g) -> tuple:
    """The plain gradient (fp32, rounded to the logits' dtype) and the
    per-element tolerance of :data:`CE_BWD_TOL` → (ref, tol), both fp32.
    Masked rows have a tolerance of 0: their gradient must be exactly 0."""
    m, d, ts, mask = stats
    ref = loss_cuda.loss_backward_plain(logits, target, stats, g).float()
    b, t, _ = logits.shape
    s = g.float().abs() / (b * t)
    softmax = torch.exp(logits.float() - m) / d
    terms = (target.float().abs() + softmax * ts.abs()) * s * mask
    return ref, CE_BWD_RTOL * ref.abs() + CE_BWD_TERM_RTOL * terms


def ce_excess(grad, ref, tol) -> float:
    """max(|grad - ref| - tol): at most 0 when the gradient passes."""
    return float(((grad.float() - ref).abs() - tol).max())


def ce_backward_phase(gen) -> dict:
    """The fused CE backward against its plain version, on a TTT step's
    window of the padded teacher, with about 20% of rows masked."""
    rows, v = BATCH * MAX_LEN, 32000
    dev = "cuda"
    logits = (torch.randn(rows, v, generator=gen, device=dev) * 2).to(
        torch.bfloat16).view(BATCH, MAX_LEN, v)
    padded = torch.softmax(torch.randn(BATCH, MAX_LEN + TTT, v, generator=gen,
                                       device=dev) * 2, dim=-1)
    target = padded[:, 3:3 + MAX_LEN]  # read through its batch stride
    mask = (torch.rand(rows, generator=gen, device=dev) > 0.2).to(
        torch.int32).view(BATCH, MAX_LEN, 1)
    _, stats = loss_cuda.loss_forward(logits, target, mask)
    g = torch.ones((), device=dev)
    grad = loss_cuda.loss_backward(logits, target, stats, g)
    torch.cuda.synchronize()
    ref, tol = ce_backward_tolerance(logits, target, stats, g)
    check(f"fused CE backward |err| - ({CE_BWD_TOL})",
          ce_excess(grad, ref, tol), 0.0)
    # the check itself must reject a gradient that lost a row's last vector
    # or its small entries
    first = int(torch.nonzero(mask.view(rows))[0])
    tail = grad.clone()
    tail.view(rows, v)[first, -8:] = 0
    small = grad.masked_fill(ref.abs() < ref.abs().mean(), 0)
    sensitivity = {"last 8 entries of an unmasked row zeroed":
                   ce_excess(tail, ref, tol),
                   "entries below the mean |ref| zeroed":
                   ce_excess(small, ref, tol)}
    for what, excess in sensitivity.items():
        if not excess > 0:
            raise AssertionError(f"the fused CE backward check passes a "
                                 f"gradient with the {what}")
    del tail, small

    lg = logits.detach().requires_grad_(True)
    flat_mask = mask.view(rows).float()
    ce = F.cross_entropy(lg.float().view(rows, v), target.reshape(rows, v),
                         reduction="none")
    library_loss = (ce * flat_mask).sum() / rows
    kept = int(mask.sum())
    nbytes = kept * v * (2 + 4) + rows * v * 2 + 4 * rows * 4
    t_bytes = nbytes / PEAK_HBM
    t_ops = 5 * kept * v / PEAK_FP32  # exp, scale, two products, subtract
    row = {
        "name": "fused_ce_bwd",
        "route": "cuda",
        "source": "specforge_tpu_torch/csrc/fused_ce.cu",
        "replaces": "specforge_tpu/ops/loss_pallas.py:125",
        "max_abs_err": max_err(grad, ref),
        "tol": CE_BWD_TOL,
        "ms": median_ms(lambda: loss_cuda.loss_backward(logits, target, stats,
                                                        g)),
        "plain_ms": median_ms(lambda: loss_cuda.loss_backward_plain(
            logits, target, stats, g)),
        "library_ms": median_ms(lambda: torch.autograd.grad(
            library_loss, lg, retain_graph=True)),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
    }
    emit({"phase": "kernel", "R": rows, "V": v, "masked_rows": rows - kept,
          "excess_of_rejected_gradients": sensitivity, **row})
    return row


# --------------------------------------------------------------------------
# the DFlash block-attention kernels against their plain versions
# --------------------------------------------------------------------------

#: (name, B, H, KVH, D, S, N, sliding window, block size): (a) the Domino
#: slice; (b) configs/qwen3-8b-dflash.json's 512 anchors at S=2048; (c) the
#: sliding window of configs/qwen3.6-27b-dflash.json, which bites at
#: S=8192; (d) head dim 64 (configs/qwen2.5-0.5b-dflash.json's heads); (e) a
#: context that is no multiple of the 64-key tile; (f) blocks of 7, the
#: kernels' pitch of 8, at configs/qwen3-4b-dspark.json's heads; (g) the
#: same at configs/glm-5.2-dspark.json's head layout (D = 64)
DFLASH_CASES = (
    ("a_domino", 2, 32, 8, 128, 768, 256, None, 16),
    ("b_dflash_s2048", 2, 32, 8, 128, 2048, 512, None, 16),
    ("c_sliding_w4096", 1, 32, 8, 128, 8192, 512, 4096, 16),
    ("d_head_dim_64", 2, 14, 2, 64, 768, 256, None, 16),
    ("e_s700", 2, 32, 8, 128, 700, 256, None, 16),
    ("f_block7", 2, 32, 8, 128, 768, 256, None, 7),
    ("g_block7_d64", 2, 64, 16, 64, 768, 256, None, 7),
)
#: the cases timed beside the library yardstick
DFLASH_LIBRARY_CASES = ("a_domino", "b_dflash_s2048", "f_block7",
                        "g_block7_d64")
DFLASH_KERNELS = ("dflash_attention_fwd", "dflash_attention_bwd_dq",
                  "dflash_attention_bwd_dkv")


def dflash_case_inputs(gen, b, h, kvh, d, s, n, bs):
    """Anchors from the port's sampler over a loss mask of the response part
    (the last three quarters; row 1 has fewer candidates than slots, so its
    last slots are not kept; row 0's first anchor is moved to 0) and bf16
    q/k/v, q and the draft k/v as strided views of one merged projection,
    as the draft model has them."""
    loss_mask = torch.zeros(b, s, dtype=torch.int32)
    loss_mask[:, s // 4:] = 1
    if b > 1:
        loss_mask[1, :s - n // 2] = 0
    anchors, keep = sample_anchor_positions(
        torch.Generator().manual_seed(int(gen.initial_seed()) + s), loss_mask,
        n)
    anchors[0, 0] = 0
    q_len = n * bs

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    qkv = rnd(b, q_len, (h + 2 * kvh) * d)
    q = qkv[..., :h * d].view(b, q_len, h, d).transpose(1, 2)
    k_drf = qkv[..., h * d:(h + kvh) * d].view(b, q_len, kvh, d).transpose(
        1, 2)
    v_drf = qkv[..., (h + kvh) * d:].view(b, q_len, kvh, d).transpose(1, 2)
    return (q, rnd(b, kvh, s, d), rnd(b, kvh, s, d), k_drf, v_drf,
            anchors.cuda(), keep.cuda())


def dflash_spans(anchors, keep, s, window, bs):
    """Allowed keys per query row [B, Q] from the anchors: context keys
    [lo, hi) and draft keys (the row's own block, or offsets <= its own under
    a sliding window): (context pairs, draft pairs) per row. The kernels'
    padding rows and keys (a block size below its pitch) are no pairs."""
    a = anchors.long().repeat_interleave(bs, dim=1)
    kept = keep.repeat_interleave(bs, dim=1)
    off = torch.arange(a.shape[1], device=a.device) % bs
    hi = a.clamp(0, s)
    lo = (a + off - (window - 1)).clamp(min=0) if window else torch.zeros_like(a)
    ctx = (hi - torch.minimum(lo, hi)) * kept
    drf = ((off + 1) if window else torch.full_like(off, bs)) * kept
    return ctx, drf


def dflash_reached_keys(anchors, keep, s, window) -> torch.Tensor:
    """[B, S] bool: the context keys some kept row may attend (block n's
    rows reach [a_n - (w - 1), a_n), all of [0, a_n) without a window)."""
    hi = anchors.long().clamp(0, s)
    lo = ((anchors.long() - (window - 1)).clamp(min=0).minimum(hi)
          if window else torch.zeros_like(hi))
    kept = keep.long()
    diff = torch.zeros(anchors.shape[0], s + 1, dtype=torch.long,
                       device=anchors.device)
    diff.scatter_add_(1, lo, kept)
    diff.scatter_add_(1, hi, -kept)
    return diff.cumsum(dim=1)[:, :s] > 0


def dflash_bounds(inputs, window, bs) -> dict:
    """The least times of the three kernels for these anchors: each input
    read once (of the context keys and values, those some kept row
    reaches: ``dflash_reached_keys``) and each output written once over the
    card's memory rate; the tensor-core products over the allowed (row,
    key) pairs at the bf16 peak (2·D operations per pair and product)."""
    q, k_ctx, _, _, _, anchors, keep = inputs
    b, h, q_len, d = q.shape
    kvh, s = k_ctx.shape[1], k_ctx.shape[2]
    ctx, drf = dflash_spans(anchors, keep, s, window, bs)
    p_ctx, p_drf = int(ctx.sum()) * h, int(drf.sum()) * h
    reached = int(dflash_reached_keys(anchors, keep, s, window).sum())
    product = 2 * d
    q_bytes = b * h * q_len * d * 2          # q, out, dO or dq
    ctx_bytes = kvh * reached * d * 2        # one context key or value read
    ctx_out_bytes = b * kvh * s * d * 2      # one of the context's dk, dv
    drf_bytes = b * kvh * q_len * d * 2      # one draft key or value tensor
    stat_bytes = b * h * q_len * 4           # one of m, l, delta
    idx_bytes = 2 * anchors.numel() * 4

    def bound(nbytes, ops):
        return {"bytes_ms": nbytes / PEAK_HBM * 1e3,
                "ops_ms": ops / PEAK_BF16 * 1e3}

    return {
        # s = q k^T and p v
        "dflash_attention_fwd": bound(
            2 * q_bytes + 2 * ctx_bytes + 2 * drf_bytes + 2 * stat_bytes
            + idx_bytes, 2 * product * (p_ctx + p_drf)),
        # s, dp, dq over every pair; the draft keys' dk, dv over theirs
        "dflash_attention_bwd_dq": bound(
            3 * q_bytes + 2 * ctx_bytes + 4 * drf_bytes + 3 * stat_bytes
            + idx_bytes, product * (3 * (p_ctx + p_drf) + 2 * p_drf)),
        # s, dp, dk, dv over the context pairs
        "dflash_attention_bwd_dkv": bound(
            2 * q_bytes + 2 * ctx_bytes + 2 * ctx_out_bytes + 3 * stat_bytes
            + idx_bytes,
            4 * product * p_ctx),
    }


def dflash_sdpa_yardstick(inputs, window, dout, bs):
    """One library call computing the same function, and its backward:
    SDPA over cat(k_ctx, k_drf) with the boolean dense DFlash mask and
    enable_gqa. Timed only (rows of blocks not kept differ: SDPA has no
    exact-zero rule for them)."""
    q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep = inputs
    b, h, q_len, d = q.shape
    mask = dflash_dense_mask(anchors, keep, k_ctx.shape[2], bs, window)
    qr = q.detach().requires_grad_(True)
    k_cat = torch.cat([k_ctx, k_drf], dim=2).requires_grad_(True)
    v_cat = torch.cat([v_ctx, v_drf], dim=2).requires_grad_(True)

    def forward():
        return F.scaled_dot_product_attention(qr, k_cat, v_cat,
                                              attn_mask=mask, enable_gqa=True)

    out = forward()
    do = dout.view(b, q_len, h, d).transpose(1, 2)
    return forward, lambda: torch.autograd.grad(out, (qr, k_cat, v_cat), do,
                                                retain_graph=True)


def dflash_kernel_phase(gen) -> list:
    """The three DFlash kernels against their plain versions in cases
    (a)-(g), in bf16: the output and every gradient within ATTN_TOL of the
    plain version's largest value, (m, l) within STAT_RTOL. Each case is
    timed (kernel, plain; the library yardstick in DFLASH_LIBRARY_CASES);
    case (a), the Domino slice's launch, gives the times and the bound the
    kernels line reports."""
    fwd = dflash_attention_cuda.dflash_flash_attention_fwd
    results = {}
    for name, b, h, kvh, d, s, n, window, bs in DFLASH_CASES:
        inputs = dflash_case_inputs(gen, b, h, kvh, d, s, n, bs)
        keep = inputs[-1]
        if window:
            lo_bites = bool(((inputs[5].long() - (window - 1)) > 0)[keep].any())
            if not lo_bites:
                raise AssertionError(f"case {name}: the window does not bite")
        out, m, l = fwd(*inputs, bs, window)
        dout = torch.randn(out.shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        grads = dflash_attention_cuda.dflash_flash_attention_bwd(
            *inputs, bs, window, out, m, l, dout)
        torch.cuda.synchronize()
        ref, ref_m, ref_l = dflash_attention_cuda.dflash_flash_attention_plain(
            *inputs, bs, window)
        ref_grads = dflash_attention_cuda.dflash_flash_attention_backward_plain(
            *inputs, bs, window, out, m, l, dout)
        kept_rows = keep.repeat_interleave(bs, dim=1)
        dead = (~kept_rows)[:, None].expand_as(m)
        if (out[~kept_rows].any() or l[dead].any()
                or (m[dead] != dflash_attention_cuda.NEG_INF).any()):
            raise AssertionError(f"case {name}: rows not kept are not out 0, "
                                 "m -1e30, l 0")
        # kernel A gives dq and the draft dk/dv, kernel B the context dk/dv
        pairs = {
            "dflash_attention_fwd": [(out, ref)],
            "dflash_attention_bwd_dq": list(zip(grads[0:1] + grads[3:],
                                                ref_grads[0:1]
                                                + ref_grads[3:])),
            "dflash_attention_bwd_dkv": list(zip(grads[1:3], ref_grads[1:3])),
        }
        errs = {k: max(rel_max_err(a, r) for a, r in v)
                for k, v in pairs.items()}
        abs_errs = {k: max(max_err(a, r) for a, r in v)
                    for k, v in pairs.items()}
        for kernel, err in errs.items():
            check(f"{kernel} case {name} (max|err| / max|ref|)", err,
                  ATTN_TOL)
        rows = kept_rows[:, None].expand_as(m)  # m is -1e30 on the others
        errs["m"] = max_err(m[rows], ref_m[rows]) / (
            1.0 + float(ref_m[rows].abs().max()))
        errs["l"] = float(((l - ref_l).abs() / ref_l.clamp(min=1e-30)).max())
        check(f"dflash m case {name}", errs["m"], STAT_RTOL)
        check(f"dflash l case {name}", errs["l"], STAT_RTOL)
        delta = attention_cuda.backward_delta(out, dout, h)
        bwd_args = (*inputs, bs, window, dout, m, l, delta)
        # every kernel: two launches give the same bits; rows of blocks not
        # kept get dq (and draft dk/dv) exactly 0, keys no kept row reaches
        # context dk/dv exactly 0
        dq_kernel = dflash_attention_cuda.dflash_attention_bwd_dq
        dkv = dflash_attention_cuda.dflash_attention_bwd_dkv
        check_repeat(f"dflash_attention_fwd case {name}",
                     lambda: fwd(*inputs, bs, window))
        check_repeat(f"dflash_attention_bwd_dq case {name}",
                     lambda: dq_kernel(*bwd_args))
        check_repeat(f"dflash_attention_bwd_dkv case {name}",
                     lambda: dkv(*bwd_args))
        if any(g.transpose(1, 2)[~kept_rows].any()
               for g in (grads[0], grads[3], grads[4])):
            raise AssertionError(f"case {name}: dq or draft dk/dv of rows "
                                 "not kept are not 0")
        unreached = ~dflash_reached_keys(inputs[5], keep, s, window)
        unreached = unreached[:, None].expand(b, kvh, s)
        if grads[1][unreached].any() or grads[2][unreached].any():
            raise AssertionError(f"case {name}: dk/dv of keys no row reaches "
                                 "are not 0")
        run = {
            "dflash_attention_fwd": run_ms(
                lambda: fwd(*inputs, bs, window)),
            "dflash_attention_bwd_dq": run_ms(lambda: dq_kernel(*bwd_args)),
            "dflash_attention_bwd_dkv": run_ms(lambda: dkv(*bwd_args)),
        }
        row = {
            "phase": "kernel", "name": "dflash_attention", "case": name,
            "fwd_repeat": "bit-exact", "dq_repeat": "bit-exact",
            "dkv_repeat": "bit-exact",
            "rows_not_kept": int((~kept_rows).sum()),
            "unreached_keys": int(unreached[:, 0].sum()),
            "run_ms": run,
            "B": b, "H": h, "KVH": kvh, "D": d, "S": s, "N": n,
            "block_size": bs,
            "block_pitch": dflash_attention_cuda.block_pitch(bs),
            "sliding_window": window, "kept_blocks": int(keep.sum()),
            "rel_err": errs, "max_abs_err": abs_errs,
            "tol": {"out_and_grads": f"{ATTN_TOL} * max|ref|",
                    "m_l": STAT_RTOL},
            "ms": {
                "dflash_attention_fwd": median_ms(
                    lambda: fwd(*inputs, bs, window)),
                "dflash_attention_bwd_dq": median_ms(
                    lambda: dflash_attention_cuda.dflash_attention_bwd_dq(
                        *bwd_args)),
                "dflash_attention_bwd_dkv": median_ms(
                    lambda: dflash_attention_cuda.dflash_attention_bwd_dkv(
                        *bwd_args)),
            },
            "plain_fwd_ms": median_ms(
                lambda: dflash_attention_cuda.dflash_flash_attention_plain(
                    *inputs, bs, window), runs=5, warmup=1),
            "plain_bwd_ms": median_ms(
                lambda: dflash_attention_cuda
                .dflash_flash_attention_backward_plain(
                    *inputs, bs, window, out, m, l, dout),
                runs=5, warmup=1),
            "bound": dflash_bounds(inputs, window, bs),
        }
        # the device's time by kernel over 5 rounds of the three wrappers:
        # at a block size below its pitch, the copies into and out of the
        # pitched layout beside the kernels themselves
        def rounds():
            for _ in range(5):
                fwd(*inputs, bs, window)
                dq_kernel(*bwd_args)
                dkv(*bwd_args)
            torch.cuda.synchronize()

        row["profile_5_rounds"] = profile_device(rounds, top=12)
        if name in DFLASH_LIBRARY_CASES:
            lib_fwd, lib_bwd = dflash_sdpa_yardstick(inputs, window, dout,
                                                     bs)
            row["library_fwd_ms"] = median_ms(lib_fwd)
            row["library_bwd_ms"] = median_ms(lib_bwd)
        emit(row)
        results[name] = row
        del inputs, out, grads, ref, ref_grads, dout, bwd_args
        torch.cuda.empty_cache()

    main = results["a_domino"]
    lines = []
    for kernel, line in zip(DFLASH_KERNELS, (103, 180, 254)):
        bound = main["bound"][kernel]
        backward = kernel != "dflash_attention_fwd"
        lines.append({
            "name": kernel,
            "route": "cuda",
            "source": "specforge_tpu_torch/csrc/dflash_attention.cu",
            "replaces": f"specforge_tpu/ops/dflash_pallas.py:{line}",
            "max_abs_err": max(r["max_abs_err"][kernel]
                               for r in results.values()),
            "rel_err": max(r["rel_err"][kernel] for r in results.values()),
            "tol": f"{ATTN_TOL} * max|ref|",
            # per launch at the Domino slice's shapes (case a), one at a
            # time and back to back; the plain backward and the library
            # backward compute every gradient at once, and stand beside both
            # backward kernels
            "ms": main["ms"][kernel],
            "run_ms": main["run_ms"][kernel],
            "plain_ms": main["plain_bwd_ms" if backward else "plain_fwd_ms"],
            "library_ms": main["library_bwd_ms" if backward
                               else "library_fwd_ms"],
            "bound_ms": max(bound["bytes_ms"], bound["ops_ms"]),
            "bound_by": ("bytes" if bound["bytes_ms"] > bound["ops_ms"]
                         else "operations"),
        })
    return lines


# --------------------------------------------------------------------------
# the P-EAGLE COD attention kernels against their plain versions
# --------------------------------------------------------------------------

#: the P-EAGLE sampler of examples/qwen3-8b-peagle-single-chip.json
COD_DEPTHS, COD_RATIO, COD_RATIO_MIN = 8, 0.7, 0.2
#: (name, B, H, KVH, D, S, document lengths per row or None for one
#: document of S, rows whose loss mask is all 0): (a) the slice's shapes;
#: (b) S=1024 packed as 4 documents of 256 (block-diagonal tiles); (c)
#: S=2048; (d) head dim 64 (Qwen2.5-0.5B's heads); (e) a row whose document
#: ends at 600 (an invalid tail) and a row with no supervised token
COD_CASES = (
    ("a_slice", 2, 32, 8, 128, 1024, None, ()),
    ("b_packed_4x256", 2, 32, 8, 128, 1024, (256, 256, 256, 256), ()),
    ("c_s2048", 1, 32, 8, 128, 2048, None, ()),
    ("d_head_dim_64", 2, 14, 2, 64, 768, None, ()),
    ("e_tail_and_unsupervised", 2, 32, 8, 128, 1024, (600,), (1,)),
)
COD_KERNELS = ("cod_attention_fwd", "cod_attention_bwd_dq",
               "cod_attention_bwd_dkv")


def cod_case_inputs(gen, b, h, kvh, d, s, doc_lengths, unsupervised):
    """A COD sample from the port's sampler and doc-major sort over a loss
    mask of the response part (the last three quarters of each document),
    and bf16 q/k/v as strided views of one merged projection, as the draft
    model has them → (q, k, v, the sample's kernel inputs)."""
    lengths = torch.tensor([list(doc_lengths or (s,))] * b, dtype=torch.int32)
    doc_ids = document_ids_from_lengths(lengths, s)
    loss_mask = torch.zeros(b, s, dtype=torch.int32)
    start = 0
    for n in doc_lengths or (s,):
        loss_mask[:, start + n // 4:start + n] = 1
        start += n
    for row in unsupervised:
        loss_mask[row] = 0
    sample = generate_cod_sample_indices(
        torch.Generator().manual_seed(int(gen.initial_seed()) + s),
        loss_mask, doc_ids, COD_DEPTHS, COD_RATIO, COD_RATIO_MIN)
    sample = doc_major(sample, doc_ids)
    anchor_doc = doc_ids.long().gather(1, sample.anchor_pos.long())
    vectors = [x.cuda() for x in (sample.anchor_pos, sample.depth, anchor_doc,
                                  sample.valid)]
    tiles = peagle_attention_cuda.cod_tiles(*vectors)
    t = sample.depth.shape[1]
    qkv = torch.randn(b, t, (h + 2 * kvh) * d, generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q = qkv[..., :h * d].view(b, t, h, d).transpose(1, 2)
    k = qkv[..., h * d:(h + kvh) * d].view(b, t, kvh, d).transpose(1, 2)
    v = qkv[..., (h + kvh) * d:].view(b, t, kvh, d).transpose(1, 2)
    return q, k, v, tiles


def cod_bounds(q, k, tiles) -> dict:
    """The least times of the three COD kernels for this sample: each input
    read once and each output written once over the card's memory rate; the
    tensor-core products over P, the allowed (query, key) pairs over all
    heads, at the bf16 peak (2·D operations per pair and product: the
    forward's two, dq's three, dk/dv's four)."""
    b, h, t, d = q.shape
    kvh = k.shape[1]
    props = tiles.props
    pairs = 0
    for r0, r1 in peagle_attention_cuda._row_chunks(q):
        pairs += int(peagle_attention_cuda._allow(props[:, r0:r1], props)
                     .sum())
    p_all = pairs * h
    q_bytes = b * h * t * d * 2          # q, out, dO or dq
    kv_bytes = b * kvh * t * d * 2       # k, v, dk or dv
    stat_bytes = b * h * t * 4           # one of m, l, delta
    prop_bytes = props.numel() * 4

    def bound(nbytes, ops):
        return {"bytes_ms": nbytes / PEAK_HBM * 1e3,
                "ops_ms": ops / PEAK_BF16 * 1e3}

    return {
        "pairs_per_head": pairs,
        "cod_attention_fwd": bound(
            2 * q_bytes + 2 * kv_bytes + 2 * stat_bytes + prop_bytes,
            4 * d * p_all),
        "cod_attention_bwd_dq": bound(
            3 * q_bytes + 2 * kv_bytes + 3 * stat_bytes + prop_bytes,
            6 * d * p_all),
        "cod_attention_bwd_dkv": bound(
            2 * q_bytes + 4 * kv_bytes + 3 * stat_bytes + prop_bytes,
            8 * d * p_all),
    }


def cod_sdpa_yardstick(q, k, v, tiles, dout):
    """One library call computing the same function, and its backward: SDPA
    with the dense boolean COD mask and enable_gqa. Timed only (rows with
    no allowed key differ: SDPA has no exact-zero rule for them)."""
    b, h, t, d = q.shape
    props = tiles.props
    mask = peagle_attention_cuda._allow(props, props)[:, None]
    qr = q.detach().requires_grad_(True)
    kr = k.detach().requires_grad_(True)
    vr = v.detach().requires_grad_(True)

    def forward():
        return F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                              enable_gqa=True)

    out = forward()
    do = dout.view(b, t, h, d).transpose(1, 2)
    return forward, lambda: torch.autograd.grad(out, (qr, kr, vr), do,
                                                retain_graph=True)


def cod_kernel_phase(gen) -> list:
    """The three COD kernels against their plain versions in cases
    (a)-(e), in bf16: the output and every gradient within ATTN_TOL of the
    plain version's largest value, (m, l) within STAT_RTOL on rows with an
    allowed key, and rows without one exactly 0. Each case is timed
    (kernel, plain); case (a), the slice's launch, also gives the library
    yardstick and the bound the kernels line reports."""
    pac = peagle_attention_cuda
    results = {}
    for name, b, h, kvh, d, s, doc_lengths, unsupervised in COD_CASES:
        q, k, v, tiles = cod_case_inputs(gen, b, h, kvh, d, s, doc_lengths,
                                         unsupervised)
        t = q.shape[2]
        out, m, l = pac.cod_attention_fwd(q, k, v, tiles)
        dout = torch.randn(out.shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        grads = pac.cod_attention_bwd(q, k, v, tiles, out, m, l, dout)
        torch.cuda.synchronize()
        ref, ref_m, ref_l = pac.cod_attention_plain(q, k, v, tiles.props)
        ref_grads = pac.cod_attention_backward_plain(q, k, v, tiles.props,
                                                     out, m, l, dout)
        live = ref_l[:, 0] > 0                                # [B, T]
        empty_rows = int((~live).sum())
        if (out[~live].any() or l.transpose(1, 2)[~live].any()
                or (m.transpose(1, 2)[~live] != pac.NEG_INF).any()):
            raise AssertionError(f"case {name}: rows without an allowed key "
                                 "are not out 0, m -1e30, l 0")
        if grads[0].transpose(1, 2)[~live].any():
            raise AssertionError(f"case {name}: dq of rows without an "
                                 "allowed key is not 0")
        pairs = {
            "cod_attention_fwd": [(out, ref)],
            "cod_attention_bwd_dq": [(grads[0], ref_grads[0])],
            "cod_attention_bwd_dkv": list(zip(grads[1:], ref_grads[1:])),
        }
        errs = {kname: max(rel_max_err(a, r) for a, r in v_)
                for kname, v_ in pairs.items()}
        abs_errs = {kname: max(max_err(a, r) for a, r in v_)
                    for kname, v_ in pairs.items()}
        for kernel, err in errs.items():
            check(f"{kernel} case {name} (max|err| / max|ref|)", err,
                  ATTN_TOL)
        rows = live[:, None].expand_as(m)
        errs["m"] = max_err(m[rows], ref_m[rows]) / (
            1.0 + float(ref_m[rows].abs().max()))
        errs["l"] = float(((l - ref_l).abs() / ref_l.clamp(min=1e-30)).max())
        check(f"cod m case {name}", errs["m"], STAT_RTOL)
        check(f"cod l case {name}", errs["l"], STAT_RTOL)
        delta = attention_cuda.backward_delta(out, dout, h)
        bwd_args = (q, k, v, tiles, dout, m, l, delta)
        # every kernel: two launches give the same bits; keys no row may
        # attend get dk/dv exactly 0 (rows with no allowed key get dq 0,
        # checked above)
        check_repeat(f"cod_attention_fwd case {name}",
                     lambda: pac.cod_attention_fwd(q, k, v, tiles))
        check_repeat(f"cod_attention_bwd_dq case {name}",
                     lambda: (pac.cod_attention_bwd_dq(*bwd_args),))
        check_repeat(f"cod_attention_bwd_dkv case {name}",
                     lambda: pac.cod_attention_bwd_dkv(*bwd_args))
        reached = torch.zeros(b, t, dtype=torch.bool, device="cuda")
        for r0, r1 in pac._row_chunks(q):
            reached |= pac._allow(tiles.props[:, r0:r1],
                                  tiles.props).any(dim=1)
        unreached = (~reached)[:, None].expand(b, kvh, t)
        if grads[1][unreached].any() or grads[2][unreached].any():
            raise AssertionError(f"case {name}: dk/dv of keys no row reaches "
                                 "are not 0")
        run = {
            "cod_attention_fwd": run_ms(
                lambda: pac.cod_attention_fwd(q, k, v, tiles)),
            "cod_attention_bwd_dq": run_ms(
                lambda: pac.cod_attention_bwd_dq(*bwd_args)),
            "cod_attention_bwd_dkv": run_ms(
                lambda: pac.cod_attention_bwd_dkv(*bwd_args)),
        }
        row = {
            "phase": "kernel", "name": "cod_attention", "case": name,
            "fwd_repeat": "bit-exact", "dq_repeat": "bit-exact",
            "dkv_repeat": "bit-exact",
            "unreached_keys": int((~reached).sum()),
            "full_tile_share": float(tiles.full.float().mean()),
            "run_ms": run,
            "B": b, "H": h, "KVH": kvh, "D": d, "S": s, "T": t,
            "doc_lengths": doc_lengths, "unsupervised_rows": list(unsupervised),
            "empty_rows": empty_rows,
            "live_tile_share": float(tiles.table.float().mean()),
            "rel_err": errs, "max_abs_err": abs_errs,
            "tol": {"out_and_grads": f"{ATTN_TOL} * max|ref|",
                    "m_l": STAT_RTOL,
                    "empty_rows": "out, dq and l exactly 0, m exactly -1e30"},
            "ms": {
                "cod_attention_fwd": median_ms(
                    lambda: pac.cod_attention_fwd(q, k, v, tiles)),
                "cod_attention_bwd_dq": median_ms(
                    lambda: pac.cod_attention_bwd_dq(*bwd_args)),
                "cod_attention_bwd_dkv": median_ms(
                    lambda: pac.cod_attention_bwd_dkv(*bwd_args)),
            },
            "plain_fwd_ms": median_ms(
                lambda: pac.cod_attention_plain(q, k, v, tiles.props),
                runs=5, warmup=1),
            "plain_bwd_ms": median_ms(
                lambda: pac.cod_attention_backward_plain(
                    q, k, v, tiles.props, out, m, l, dout),
                runs=5, warmup=1),
            "bound": cod_bounds(q, k, tiles),
        }
        if name == "a_slice":
            lib_fwd, lib_bwd = cod_sdpa_yardstick(q, k, v, tiles, dout)
            row["library_fwd_ms"] = median_ms(lib_fwd)
            row["library_bwd_ms"] = median_ms(lib_bwd)
        emit(row)
        results[name] = row
        del q, k, v, tiles, out, grads, ref, ref_grads, dout, bwd_args
        torch.cuda.empty_cache()

    main = results.get("a_slice", next(iter(results.values())))
    lines = []
    for kernel, line in zip(COD_KERNELS, (87, 143, 189)):
        bound = main["bound"][kernel]
        backward = kernel != "cod_attention_fwd"
        lines.append({
            "name": kernel,
            "route": "cuda",
            "source": "specforge_tpu_torch/csrc/peagle_attention.cu",
            "replaces": f"specforge_tpu/ops/peagle_pallas.py:{line}",
            "max_abs_err": max(r["max_abs_err"][kernel]
                               for r in results.values()),
            "rel_err": max(r["rel_err"][kernel] for r in results.values()),
            "tol": f"{ATTN_TOL} * max|ref|",
            # per launch at the slice's shapes (case a), one at a time and
            # back to back; the plain backward and the library backward
            # compute every gradient at once, and stand beside both backward
            # kernels
            "ms": main["ms"][kernel],
            "run_ms": main["run_ms"][kernel],
            "plain_ms": main["plain_bwd_ms" if backward else "plain_fwd_ms"],
            "library_ms": main.get("library_bwd_ms" if backward
                                   else "library_fwd_ms"),
            "bound_ms": max(bound["bytes_ms"], bound["ops_ms"]),
            "bound_by": ("bytes" if bound["bytes_ms"] > bound["ops_ms"]
                         else "operations"),
        })
    return lines


# --------------------------------------------------------------------------
# the slice: EAGLE3 offline TTT forward at Qwen3-8B width
# --------------------------------------------------------------------------

def write_features(root: Path, cfg: Eagle3Config, seed: int, n_files: int,
                   min_len: int, max_len: int, response_only=False,
                   fmt: str = "sft") -> None:
    """Offline feature files in the layout of tests/_fixtures.py, written by
    the port's writer from a CPU generator. The loss mask is random, or
    with ``response_only`` 0 over a prompt of a tenth to a third of the
    sample and 1 over the response after it. ``fmt="ckpt"`` writes them as
    the reference does (``torch.save`` dicts, the first ``GZ_FILES``
    gzipped at level 1); ``fmt="mrope"`` gives each sample one vision span
    (its image-token run located by ``spans_from_token_ids``) and its [3, S]
    ``position_ids`` from ``mrope_position_ids``."""
    gen = torch.Generator().manual_seed(seed)
    h = cfg.resolved_target_hidden_size
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        n = int(torch.randint(min_len, max_len + 1, (1,), generator=gen))
        if response_only:
            loss_mask = torch.zeros(n, dtype=torch.int64)
            loss_mask[int(torch.randint(n // 10, n // 3, (1,),
                                        generator=gen)):] = 1
        else:
            loss_mask = (torch.rand(n, generator=gen) > 0.25).to(torch.int64)
        tensors = {
            "input_ids": torch.randint(0, cfg.vocab_size, (n,), generator=gen),
            "loss_mask": loss_mask,
            "hidden_state": torch.randn(n, 3 * h, generator=gen).to(
                torch.bfloat16),
            "target": torch.randn(n, h, generator=gen).to(torch.bfloat16),
        }
        path = root / f"sample-{i:04d}"
        if fmt == "ckpt":
            if i < GZ_FILES:
                with gzip.open(f"{path}.ckpt.gz", "wb", compresslevel=1) as f:
                    torch.save(tensors, f)
            else:
                torch.save(tensors, f"{path}.ckpt")
            continue
        if fmt == "mrope":
            t, hh, w = VISION_GRID
            start = n // 8
            tensors["input_ids"][start:start + t * hh * w] = IMAGE_TOKEN_ID
            spans = spans_from_token_ids(tensors["input_ids"].numpy(),
                                         IMAGE_TOKEN_ID, [VISION_GRID])
            tensors["position_ids"] = torch.from_numpy(
                mrope_position_ids(n, spans))
        save_feature_file(f"{path}.sft", tensors,
                          {"target_repr": "hidden_state"})


def vocab_map(cfg: Eagle3Config, seed: int):
    gen = torch.Generator().manual_seed(seed + 1)
    keep = torch.randperm(cfg.vocab_size, generator=gen)[
        :cfg.draft_vocab_size].sort().values
    t2d = torch.zeros(cfg.vocab_size, dtype=torch.bool)
    t2d[keep] = True
    d2t = keep - torch.arange(cfg.draft_vocab_size)
    return t2d.numpy(), d2t.numpy()


def run_slice(cfg: Eagle3Config, device, seed: int, workdir: Path, *,
              dtype=torch.bfloat16, batch=BATCH, max_length=MAX_LEN,
              n_files=N_FILES, min_len=1536, head_std=0.02):
    """Data plane → Evaluator.run → forward_loss(compact teacher), on the
    plain path (dense attention, reference CE) and on the kernel path
    ("pallas" attention, fused CE) with the same weights and batches.
    Returns (kernel results, plain results, counts); the launch counters are
    set to 0 just before the kernel path and read just after it."""
    feat_dir = workdir / "features"
    write_features(feat_dir, cfg, seed, n_files, min_len, max_length)
    specs, meta = read_feature_specs(str(next(feat_dir.glob("*.sft"))))
    assert meta.get("target_repr") == "hidden_state", meta
    save_vocab_mapping(str(workdir / "vocab.npz"), *vocab_map(cfg, seed))
    t2d, d2t = load_vocab_mapping(str(workdir / "vocab.npz"))

    metadata = {"target_repr": "hidden_state"}
    loader = FeatureDataLoader(
        FileFeatureStore(), PaddingCollator(CollatorConfig(max_length)),
        refs=OfflineManifestReader(str(feat_dir)).read(), batch_size=batch,
        num_workers=2, metadata=metadata,
    )
    batches = list(loader)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    head = (torch.randn(cfg.vocab_size, cfg.resolved_target_hidden_size,
                        generator=gen, device=device) * head_std).to(dtype)
    frozen = {"target_head_weight": head}

    def make_strategy(backend, loss_backend, state=None):
        draft = LlamaEagle3Draft(cfg, dtype=dtype, attention_backend=backend,
                                 device=device, seed=seed)
        draft.set_vocab_maps(t2d, d2t)
        if state is not None:
            draft.load_state_dict(state)
        model = OnlineEagle3Model(draft, length=TTT, loss_backend=loss_backend)
        return Eagle3TrainStrategy(model, compact_teacher=True)

    def run(strategy):
        sync = torch.cuda.synchronize if device.type == "cuda" else (
            lambda: None)
        sync()
        t0 = time.perf_counter()
        metrics = Evaluator(strategy, metadata).run(batches, frozen)
        sync()
        t1 = time.perf_counter()
        with torch.no_grad():
            out = strategy.forward_loss(batches[0].tensors, frozen,
                                        metadata=metadata)
        fl = {
            "loss": float(out.loss),
            **{k: float(v) for k, v in out.metrics.items()},
            **{k: float(n / d) for k, (n, d) in out.ratio_metrics.items()},
        }
        return {"eval": metrics, "forward_loss": fl,
                "eval_ms_per_forward": (t1 - t0) * 1e3 / len(batches)}

    kernel_strategy = make_strategy("pallas", "fused")
    plain_strategy = make_strategy(
        "dense", "reference", kernel_strategy.model.draft_model.state_dict())
    # the plain path launches no kernel of the port and goes first, so that
    # one-time set-up (cuBLAS, the allocator) is not charged to the kernels
    plain = run(plain_strategy)
    counted = {"batches": len(batches), "forwards": len(batches) + 1}
    attention_cuda.ttt_flash_attention_fwd.launches = 0
    loss_cuda.loss_forward.launches = 0
    kernel = run(kernel_strategy)
    counted["launches"] = {
        "ttt_flash_attention_fwd":
            attention_cuda.ttt_flash_attention_fwd.launches,
        "fused_ce_fwd": loss_cuda.loss_forward.launches,
    }
    for result, strategy in ((kernel, kernel_strategy), (plain, plain_strategy)):
        result["forward_loss_ms"] = time_forward(strategy, batches[0], frozen,
                                                 metadata, device)
    if device.type == "cuda":
        kernel["profile"] = profile_forward(kernel_strategy, batches[0],
                                            frozen, metadata)
    tokens = sum(int(b.tensors["attention_mask"].sum()) for b in batches)
    counted["real_tokens"] = tokens
    counted["padded_tokens"] = len(batches) * batch * max_length
    return kernel, plain, counted


def time_forward(strategy, batch, frozen, metadata, device, runs=3) -> float:
    """Median wall time of forward_loss (compact teacher) on one batch,
    ending in a device synchronise."""
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = strategy.forward_loss(batch.tensors, frozen,
                                        metadata=metadata)
        float(out.loss)  # waits for the device
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_forward(strategy, batch, frozen, metadata, top=15) -> dict:
    """One forward_loss under torch.profiler (see :func:`profile_device`)."""
    def run():
        with torch.no_grad():
            out = strategy.forward_loss(batch.tensors, frozen,
                                        metadata=metadata)
        float(out.loss)

    return profile_device(run, top)


def profile_device(fn, top=15) -> dict:
    """``fn()`` (which ends by waiting for the device) under torch.profiler:
    device time by kernel, and the device's idle share of the (profiled, so
    slower) wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets); CUPTI's own buffer
    # requests are bookkeeping. Busy time is the union of their intervals,
    # so events that overlap are not counted twice.
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.name.startswith("Activity Buffer")]
    if not events:
        return {"wall_ms": wall, "device_busy_ms": None, "idle_share": None,
                "note": "the trace holds no device events: not measured"}
    by_name: dict = {}
    for e in events:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           calls + 1)
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    busy /= 1e3
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "wall_ms": wall,
        "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall,
        "top": [{"name": n[:120], "device_ms": ms, "calls": c}
                for n, (ms, c) in rows[:top]],
    }


def compare_slice(kernel: dict, plain: dict) -> float:
    worst = 0.0
    pairs = [(f"eval/{k}_{i}", kernel["eval"], plain["eval"])
             for k in ("ploss", "acceptance_rate") for i in range(TTT)]
    pairs += [(f"{k}_{i}", kernel["forward_loss"], plain["forward_loss"])
              for k in ("ploss", "acceptance_rate") for i in range(TTT)]
    for key, a, b in pairs:
        if not (torch.isfinite(torch.tensor(a[key]))
                and torch.isfinite(torch.tensor(b[key]))):
            raise AssertionError(f"{key} is not finite: {a[key]}, {b[key]}")
        rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-12)
        check(f"slice {key} kernel vs plain", rel, SLICE_RTOL)
        worst = max(worst, rel)
    return worst


# --------------------------------------------------------------------------
# slice 2: EAGLE3 offline training at Qwen3-8B width
# --------------------------------------------------------------------------

KERNEL_COUNTERS = {
    "ttt_flash_attention_fwd": attention_cuda.ttt_flash_attention_fwd,
    "fused_ce_fwd": loss_cuda.loss_forward,
    "fused_ce_bwd": loss_cuda.loss_backward,
    "ttt_attention_bwd_dq": attention_cuda.ttt_attention_bwd_dq,
    "ttt_attention_bwd_dkv": attention_cuda.ttt_attention_bwd_dkv,
}
BACKWARD_KERNELS = ("fused_ce_bwd", "ttt_attention_bwd_dq",
                    "ttt_attention_bwd_dkv")


def write_target_dir(root: Path, vocab_size: int, hidden_size: int, device,
                     seed: int, std: float) -> Path:
    """A random HF-layout target directory (``config.json`` and one
    ``model.safetensors`` with the bf16 lm_head and embedding), written by
    the port's safetensors writer, so the trainer loads them for real."""
    root.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    shape = (vocab_size, hidden_size)
    tensors = {
        key: (torch.randn(*shape, generator=gen, device=device) * std).to(
            torch.bfloat16).cpu()
        for key in ("lm_head.weight", "model.embed_tokens.weight")
    }
    save_feature_file(str(root / "model.safetensors"), tensors)
    (root / "config.json").write_text(json.dumps({
        "vocab_size": vocab_size, "hidden_size": hidden_size,
        "tie_word_embeddings": False,
    }))
    return root


def training_run_json(workdir: Path, draft_config: Path, target: Path,
                      max_length: int,
                      vocab_mapping: Optional[Path] = None) -> Path:
    """``examples/qwen3-8b-eagle3-offline.json``, read as data, pointed at
    this run's directories (and vocab mapping, else the run derives one
    from the features) and cut to 2 optimizer steps of 2 micro-batches
    (save every step, eval at the end of the epoch)."""
    raw = json.loads(EXAMPLE.read_text())
    raw["run_id"] = "smoke"
    raw["output_dir"] = str(workdir / "runs")
    raw["model"].update(target_model_path=str(target),
                        draft_config_path=str(draft_config))
    if vocab_mapping is not None:
        raw["model"]["vocab_mapping_path"] = str(vocab_mapping)
    raw["data"].update(train_data_path=str(workdir / "train"),
                       eval_data_path=str(workdir / "eval"),
                       max_length=max_length, num_workers=2)
    raw["training"].update(num_epochs=1, accumulation_steps=ACCUM,
                           save_interval=1, eval_interval=0, log_interval=1)
    raw["tracking"] = {"backend": "jsonl"}
    path = workdir / "run.json"
    path.write_text(json.dumps(raw, indent=2))
    return path


def step_records(output_dir: Path, run_id: str) -> list:
    """Per-step train metrics from a run's JSONL tracker."""
    path = output_dir / f"{run_id}.metrics.jsonl"
    records = [json.loads(line) for line in path.read_text().splitlines()]
    return [r for r in records if "train/loss" in r]


def first_window(trainer) -> list:
    """The first accumulation window's micro-batches, as the trainer sees
    them."""
    it = iter(trainer.train_loader)
    return [next(it).tensors for _ in range(trainer.config.accum_steps)]


def stack_window(window) -> dict:
    return {k: torch.stack([m[k] for m in window]) for k in window[0]}


def window_grads(trainer, window) -> tuple:
    """Step 1's loss and gradients over one window, from the train step the
    trainer runs (its ``accumulate``: the gradients the optimizer receives,
    before the clip and the update) → (loss, {name: fp32 grad})."""
    grads, stats = trainer.train_step.accumulate(
        trainer.state, stack_window(window), trainer.frozen)
    return float(stats["loss"] / stats["norm"]), grads


def compare_grads(kernel: dict, plain: dict) -> dict:
    """Per parameter: cosine and relative norm difference of two gradients.
    A gradient that is exactly zero on both paths (Domino's correction head
    while lambda_base is 1) is recorded as such."""
    out = {}
    for name, a in kernel.items():
        b = plain[name]
        # in fp64: over 1e8 elements an fp32 dot product drifts by percents
        # (cosines above 1 were read that way)
        a, b = a.to(b.device).double().flatten(), b.double().flatten()
        na, nb = float(a.norm()), float(b.norm())
        if na == nb == 0.0:
            out[name] = {"cosine": None, "both_zero": True}
            continue
        cos = float(a @ b) / (na * nb) if na and nb else 0.0
        out[name] = {"cosine": cos, "norm_rel_diff": abs(na - nb) / nb}
        if not cos >= GRAD_COSINE:
            raise AssertionError(f"step-1 grad of {name}: cosine {cos} "
                                 f"below {GRAD_COSINE}")
        check(f"step-1 grad norm of {name}", abs(na - nb) / nb,
              GRAD_NORM_RTOL)
    return out


def measure_kernel_path(trainer, window, sync) -> dict:
    """Timings of the train step that ``cli train`` runs, on a kernel-path
    trainer (whose state they change): the micro-step (``micro_step``:
    forward and backward of one micro-batch, twice over the window), the
    optimizer step (the train step's ``update``: global norm, clip and the
    AdamW step, row-sparse where the run asks for it), one profiled
    micro-step,
    and the peak memory of a train step with and without
    ``compute_params_dtype``."""
    step = trainer.train_step
    micro_ms = []
    for tensors in window + window:
        sync()
        t0 = time.perf_counter()
        grads, _ = step.micro_step(trainer.state, tensors, trainer.frozen)
        sync()
        micro_ms.append((time.perf_counter() - t0) * 1e3)
        del grads
    results = {"micro_step_ms": statistics.median(micro_ms[1:]),
               "micro_step_ms_all": micro_ms}
    grads, stats = step.accumulate(trainer.state, stack_window(window),
                                   trainer.frozen)
    opt_times = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        step.update(trainer.state, grads, stats)
        sync()
        opt_times.append((time.perf_counter() - t0) * 1e3)
    del grads, stats
    results["optimizer_step_ms"] = statistics.median(opt_times)
    if not next(iter(trainer.state.params.values())).is_cuda:
        return results

    def one_micro_step():
        step.micro_step(trainer.state, window[0], trainer.frozen)
        sync()

    results["profile_micro_step"] = profile_device(one_micro_step)
    default = trainer.config.compute_params_dtype
    cast = make_train_step(
        trainer.strategy, trainer.optimizer,
        accum_steps=trainer.config.accum_steps,
        total_steps=trainer.total_steps, metadata=trainer.metadata,
        lr_schedule=trainer.lr_schedule,
        grads_dtype=trainer.config.grads_dtype,
        compute_params_dtype="bfloat16", sparse_embed=trainer.sparse_plan)
    for name, train_step in ((default, step), ("bfloat16", cast)):
        sync()
        torch.cuda.reset_peak_memory_stats()
        trainer.state, _ = train_step(trainer.state, stack_window(window),
                                      trainer.frozen)
        sync()
        results[f"train_step_peak_bytes_compute_params_dtype_{name}"] = (
            torch.cuda.max_memory_allocated())
    return results


def check_run_dir_warm_start(trainer_for, step_dir: Path) -> dict:
    """A fresh run warm-started (``model.draft_checkpoint_path``) from a
    step directory of the port's own: its masters and vocab buffers equal
    the saved ones bit for bit, and its optimizer starts fresh (step 0,
    every moment 0)."""
    saved = CheckpointManager.load_state(str(step_dir))
    warm = trainer_for('run_id="warm"',
                       f'model.draft_checkpoint_path="{step_dir}"')
    differing = [n for n, w in saved["params"].items() if not torch.equal(
        warm.state.params[n].detach().cpu(), w)]
    differing += [n for n in ("draft_model.t2d", "draft_model.d2t")
                  if not torch.equal(warm.state.buffers[n].cpu(),
                                     saved["buffers"][n])]
    fresh = warm.state.step == 0 and opt_state_is_fresh(warm.state.opt_state)
    del warm
    check("run-directory warm start: tensors differing from the saved "
          "masters", float(len(differing)), 0.0)
    check("run-directory warm start: optimizer not fresh",
          0.0 if fresh else 1.0, 0.0)
    return {"from": step_dir.name, "tensors": len(saved["params"]) + 2,
            "bit_identical": not differing, "optimizer_fresh": fresh}


def opt_state_is_fresh(tree) -> bool:
    """Every floating tensor of an optimizer state is 0 (no step taken)."""
    if isinstance(tree, dict):
        return all(opt_state_is_fresh(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(opt_state_is_fresh(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return not bool(tree.any())
    return True


def run_training(cfg_path: Path, device, seed: int, workdir: Path,
                 captured: dict, *, max_length=MAX_LEN, overrides=()) -> dict:
    """Slice 2 end to end on the features ``capture_phase`` captured into
    ``workdir`` (its target's head and embedding, its vocab mapping), and
    slice 16's exports of the run's final checkpoint; returns the results
    and the launch counts of the main path (the ``cli train`` run), which
    are set to 0 just before it and read just after."""
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    target = captured["target"]
    run_json = training_run_json(workdir, cfg_path, target, max_length,
                                 captured["vocab_mapping"])
    runs = workdir / "runs"
    overrides = list(overrides)
    device_args = [] if on_card else ["--device", str(device)]

    def trainer_for(*extra):
        config = load_config(str(run_json), overrides + list(extra))
        return build_training_run(config, device=None if on_card else device)

    # the main path: cli train, 2 optimizer steps + eval + checkpoints
    results = {}
    for fn in KERNEL_COUNTERS.values():
        fn.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    rc = cli.main(["train", "-c", str(run_json), *device_args,
                   *[a for o in overrides for a in ("--set", o)]])
    sync()
    results["cli_train_s"] = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}
    if rc != 0:
        raise AssertionError(f"cli train exited {rc}")
    if on_card:
        results["cli_train_peak_bytes"] = torch.cuda.max_memory_allocated()
    kernel_steps = step_records(runs, "smoke")
    final_dir = CheckpointManager.resolve_step_dir(str(runs))
    final = CheckpointManager.load_state(final_dir)["params"]
    # slice 16: the run's final checkpoint exported both ways, while its
    # root holds this one run
    results["export"] = check_exports(runs, Path(final_dir), cfg_path,
                                      target, workdir / "export", device)

    # resume: a fresh kernel-path run from the uninterrupted run's step-1
    # checkpoint. Until its fit restores that checkpoint it holds the same
    # initial weights as the cli run, so it first gives the kernel path's
    # step-1 loss and gradients (kept on the host until the plain path's)
    resumed = trainer_for('run_id="resumed"', "training.save_interval=0",
                          f"training.resume_from={runs / 'smoke-step1'}")
    window = first_window(resumed)
    loss_k, grads_k = window_grads(resumed, window)
    grads_k = {k: g.cpu() for k, g in grads_k.items()}
    resumed.fit()
    exact = all(torch.equal(resumed.state.params[n].detach().cpu(), w)
                for n, w in final.items())
    worst = max(rel_max_err(resumed.state.params[n].detach().cpu(), w)
                for n, w in final.items())
    if not exact:
        check("resumed weights vs uninterrupted (max|err| / max|w|)", worst,
              1e-6)
    results["resume"] = {"from": "smoke-step1", "steps": resumed.state.step,
                         "bit_exact": exact, "max_rel_err": worst}
    results.update(measure_kernel_path(resumed, window, sync))
    del resumed
    if on_card:
        torch.cuda.empty_cache()
    results["run_dir_warm_start"] = check_run_dir_warm_start(
        trainer_for, runs / "smoke-step1")

    # the plain path from the same initial weights: dense attention and the
    # reference CE, through the same Trainer
    plain = trainer_for('run_id="plain"', 'training.attention_backend="dense"',
                        "training.save_interval=0")
    plain.strategy.model.loss_fn = log_softmax_loss_reference
    loss_p, grads_p = window_grads(plain, window)
    check("step-1 loss, kernel vs plain", abs(loss_k - loss_p) / abs(loss_p),
          TRAIN_STEP1_RTOL)
    results["step1_grads"] = compare_grads(grads_k, grads_p)
    del grads_k, grads_p
    plain_steps = train_windows(plain)
    del plain
    curve = []
    for k, p in zip(kernel_steps, plain_steps, strict=True):
        rel = abs(k["train/loss"] - p["train/loss"]) / abs(p["train/loss"])
        if not (math.isfinite(k["train/loss"]) and math.isfinite(
                p["train/loss"])):
            raise AssertionError(f"step {k['step']}: loss not finite")
        check(f"step {k['step']} train/loss, kernel vs plain", rel,
              TRAIN_STEP1_RTOL if k["step"] == 1 else TRAIN_DRIFT_RTOL)
        curve.append({"step": k["step"], "loss": k["train/loss"],
                      "plain_loss": p["train/loss"], "rel_diff": rel,
                      "grad_norm": k["train/grad_norm"],
                      "plain_grad_norm": p["train/grad_norm"]})
    results["loss_curve"] = curve
    if on_card:
        torch.cuda.empty_cache()
    tokens = 0
    for path in sorted((workdir / "train").glob("*.sft")):
        specs, _ = read_feature_specs(str(path))
        tokens += min(specs["input_ids"].shape[0], max_length)
    results.update({
        "optimizer_steps": len(kernel_steps),
        "micro_batches": len(kernel_steps) * ACCUM,
        "eval_forwards": EVAL_FILES // BATCH,
        "real_train_tokens": tokens,
        "tokens_per_s": BATCH * max_length / (results["micro_step_ms"] / 1e3),
        "final_eval": final_eval(final_dir),
    })
    shutil.rmtree(runs, ignore_errors=True)
    return results, counts


# --------------------------------------------------------------------------
# slice 16: capture → train → export: the dense Qwen3-8B target, offline
# capture through the qwen template, the parser and the runner, then the
# training phase on the captured features and cli export of its checkpoint
# --------------------------------------------------------------------------

#: Qwen3-8B's config.json (Qwen/Qwen3-8B on the HF hub): the target the
#: capture phase writes, with random weights from --seed
QWEN3_8B_TARGET = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3",
    "vocab_size": 151936, "hidden_size": 4096, "intermediate_size": 12288,
    "num_hidden_layers": 36, "num_attention_heads": 32,
    "num_key_value_heads": 8, "head_dim": 128, "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0, "max_position_embeddings": 40960,
    "hidden_act": "silu", "attention_bias": False,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
}
#: the target's depth in the default run, for its 1,200 s: at 36 layers
#: the whole script took 1,133 s on one H100 (the capture phase 45 s of
#: it, the target's 16.4 GB written and read back); at 12 layers (7.1 GB)
#: it ran past 1,200 s once the online phase served the same target; at 6
#: the target is 3.9 GB and the capture layers (1, 2, 2) by the same rule.
#: ``--capture-only`` (and ``--online-only``) run all 36
CAPTURE_DEPTH = 6
#: padded rows a capture forward takes: a layer's fp32 scores are then
#: 4 · 32 · 2048² · 4 B = 2.1 GB, with the softmax's copy 4.3 GB
CAPTURE_BATCH = 4
#: decoder layers a safetensors shard of the target holds (1.5 GB)
SHARD_LAYERS = 4
#: the target's weights: HF's initializer_range for Qwen3, RMSNorm
#: weights 1; the residual stream grows to a std of about 10 over 36
#: layers and stays finite
TARGET_STD = 0.02
#: the bf16 capture against an fp32 run of the same forward, and a sample
#: captured alone against its row in a padded batch: relative L2 error of
#: each captured tensor (aux layers, last hidden) over the real tokens.
#: bf16 rounds each activation to 2^-9 and the error grows with depth and
#: width over random layers: 36-layer CPU runs at widths 512, 1024 and
#: 2048 gave 1.3%, 1.8% and 3.4% at the last layer, so about 7% at 4096;
#: two bf16 runs in another order differ by as much
CAPTURE_REL_L2 = 0.1
#: the fields of a target's config.json each capture line reports
TARGET_FIELDS = (
    "model_type", "vocab_size", "hidden_size", "intermediate_size",
    "moe_intermediate_size", "num_hidden_layers", "num_attention_heads",
    "num_key_value_heads", "head_dim", "q_lora_rank", "kv_lora_rank",
    "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "n_routed_experts",
    "num_experts_per_tok", "n_shared_experts", "first_k_dense_replace",
    "topk_method", "scoring_func", "rope_theta", "rope_scaling")
#: DeepSeek-V2-Lite's config.json (deepseek-ai/DeepSeek-V2-Lite on the HF
#: hub): the MoE target slice 17's capture writes, with random weights
#: from --seed; configs/deepseek-v2-lite-eagle3.json is its EAGLE3 draft
DEEPSEEK_V2_LITE_TARGET = {
    "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2",
    "vocab_size": 102400, "hidden_size": 2048, "intermediate_size": 10944,
    "moe_intermediate_size": 1408, "num_hidden_layers": 27,
    "num_attention_heads": 16, "num_key_value_heads": 16,
    "q_lora_rank": None, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "v_head_dim": 128, "n_routed_experts": 64,
    "num_experts_per_tok": 6, "n_shared_experts": 2, "moe_layer_freq": 1,
    "first_k_dense_replace": 1, "topk_method": "greedy", "n_group": 1,
    "topk_group": 1, "norm_topk_prob": False, "scoring_func": "softmax",
    "routed_scaling_factor": 1.0, "hidden_act": "silu",
    "max_position_embeddings": 163840, "rms_norm_eps": 1e-6,
    "rope_theta": 10000, "rope_scaling": {
        "type": "yarn", "factor": 40, "beta_fast": 32, "beta_slow": 1,
        "mscale": 0.707, "mscale_all_dim": 0.707,
        "original_max_position_embeddings": 4096},
    "attention_bias": False, "tie_word_embeddings": False,
    "bos_token_id": 100000, "eos_token_id": 100001,
    "torch_dtype": "bfloat16",
}
#: the MoE target's depth in the default run, for its 1,200 s: 1 dense and
#: 5 MoE layers, 3.4 B parameters (6.9 GB). At 8 layers (9.2 GB) a whole
#: run reached its last phase line at 1,226 s on one H100, over the 1,165
#: s it is allowed. ``--capture-only`` runs all 27 (15.7 B, 31.4 GB) and
#: captures at (1, 12, 23) by the EAGLE3 rule
MOE_CAPTURE_DEPTH = 6
#: the capture layers at that depth, by the run's override: the EAGLE3
#: rule gives (1, 2, 2) at 6 layers
MOE_CAPTURE_LAYERS = (1, 2, 4)
#: decoder layers a shard of the MoE target holds (2.3 GB)
MOE_SHARD_LAYERS = 2
#: the least share of each MoE layer's (token, expert) assignments a bf16
#: capture shares with the fp32 run, and a sample alone with its padded
#: row: CPU runs of a DeepSeek-V2-Lite-shaped target (4-27 layers at widths
#: 256-2048) agreed on 98.1-99.5%, and their relative L2 errors stayed
#: under 1.7% (so ``CAPTURE_REL_L2`` holds for the MoE target too)
MOE_ROUTE_AGREEMENT = 0.95
#: the fp32 capture through ``moe_impl="dense"`` against ``gathered``, per
#: element |d - g| <= tol * (1 + |g|): the CPU parity tests' 2e-4
MOE_IMPL_TOL = 2e-4
#: the stand-in tokenizer's lexicon: distinct words, drawn Zipf-like
LEXICON_WORDS = 50000


class SpreadTokenizer:
    """A stand-in word tokenizer (the machine with the card has no
    tokenizer package) whose ids spread over the target's whole
    vocabulary: each whitespace-separated piece of text is one token, its
    id the piece's CRC-32 modulo the vocabulary size. No BOS, as Qwen3's
    tokenizer has none."""

    bos_token_id = None

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text, add_special_tokens=False):
        return [zlib.crc32(piece.encode()) % self.vocab_size
                for piece in text.split()]


def synthetic_conversations(n: int, tokenizer, seed: int, min_len: int,
                            max_len: int) -> list:
    """``n`` conversation records from the seed: user and assistant turns
    of words drawn Zipf-like from a synthetic lexicon, added until the
    rendered sample (the qwen template) reaches a length drawn from
    [min_len, max_len]; ``build_dataset`` cuts one past max_len."""
    rng = np.random.default_rng(seed + 5)
    codes = rng.integers(ord("a"), ord("z") + 1, size=(LEXICON_WORDS, 10))
    lexicon = ["".join(map(chr, row[:k])) for row, k in zip(
        codes, rng.integers(2, 11, size=LEXICON_WORDS))]
    weights = 1.0 / np.arange(1, LEXICON_WORDS + 1) ** 1.05
    weights /= weights.sum()
    parser = build_parser_for_template(tokenizer, "qwen")

    def words(lo, hi):
        picks = rng.choice(LEXICON_WORDS, size=int(rng.integers(lo, hi)),
                           p=weights)
        return " ".join(lexicon[i] for i in picks)

    # turns of up to 1/16 (user) and 1/5 (assistant) of the longest sample
    user, assistant = (1, max(2, max_len // 16)), (2, max(3, max_len // 5))
    records = []
    for _ in range(n):
        goal = int(rng.integers(min_len, max_len + 1))
        messages = []
        while len(parser.parse(messages, 1 << 30).input_ids) < goal:
            messages.append({"role": "user", "content": words(*user)})
            messages.append({"role": "assistant",
                             "content": words(*assistant)})
        records.append({"messages": messages})
    return records


def write_capture_target(root: Path, config: dict, device, seed: int,
                         std: float, shard_layers: int = SHARD_LAYERS
                         ) -> Path:
    """A random HF checkpoint directory of ``config`` (any family: the
    tensors of ``tests/_torch_targets.tensor_shapes``): bf16 weights drawn
    on ``device`` from the seed (a shard's in one draw), norms 1 (a
    zero-centred norm's 0), biases 0, written as safetensors shards (the
    embedding, head and final norm in the first, ``shard_layers`` decoder
    layers in each of the others) with their
    ``model.safetensors.index.json``, by the port's writer."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(config, indent=2))
    tc = TargetConfig.from_file(str(root))
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    fill = {"norm1": 1.0, "norm0": 0.0, "bias": 0.0}

    def values(shapes: dict) -> dict:
        drawn = [k for k, (_, kind) in shapes.items()
                 if kind in ("weight", "embed")]
        sizes = [math.prod(shapes[k][0]) for k in drawn]
        flat = (torch.randn(sum(sizes), generator=gen, device=device)
                * std).to(torch.bfloat16).cpu()
        out = {k: t.view(shapes[k][0])
               for k, t in zip(drawn, torch.split(flat, sizes))}
        for k, (shape, kind) in shapes.items():
            if k not in out:
                if kind not in fill:
                    raise ValueError(f"no full-width value for a {kind} "
                                     "tensor")
                out[k] = torch.full(shape, fill[kind], dtype=torch.bfloat16)
        return out

    layers = tc.num_hidden_layers
    groups = [range(lo, min(lo + shard_layers, layers))
              for lo in range(0, layers, shard_layers)]
    n_shards = 1 + len(groups)
    weight_map, total = {}, 0

    def save(index: int, shapes: dict) -> None:
        nonlocal total
        tensors = values(shapes)
        name = f"model-{index + 1:05d}-of-{n_shards:05d}.safetensors"
        save_feature_file(str(root / name), tensors)
        weight_map.update(dict.fromkeys(tensors, name))
        total += sum(t.numel() * t.element_size() for t in tensors.values())

    shapes = tensor_shapes(tc, config)
    save(0, {k: v for k, v in shapes.items()
             if not k.startswith("model.layers.")})
    for shard, group in enumerate(groups, start=1):
        save(shard, {k: v for i in group
                     for k, v in layer_shapes(tc, config, i).items()})
    (root / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))
    return root


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm())


def capture_errors(got: torch.Tensor, ref: torch.Tensor, layers, hidden: int
                   ) -> dict:
    """Relative L2 error of each captured layer's slice of an aux concat
    [..., L·H] and of the last hidden, from (aux, last) pairs."""
    (aux, last), (aux_ref, last_ref) = got, ref
    out = {f"layer_{layer}": rel_l2(aux[..., j * hidden:(j + 1) * hidden],
                                    aux_ref[..., j * hidden:(j + 1) * hidden])
           for j, layer in enumerate(layers)}
    out["last_hidden"] = rel_l2(last, last_ref)
    return out


def route_agreement(got: torch.Tensor, ref: torch.Tensor, experts: int
                    ) -> float:
    """The share of ``ref``'s (token, expert) assignments [T, k] that
    ``got`` makes too."""
    got = F.one_hot(got, experts).sum(dim=1)
    ref = F.one_hot(ref, experts).sum(dim=1)
    return float((got * ref).sum() / ref.sum())


def route_agreements(got: dict, ref: dict, experts: int, got_rows=None,
                     ref_rows=None) -> dict:
    """``route_agreement`` of each MoE layer's recorded routing (over the
    token rows ``got_rows`` and ``ref_rows`` of each, all when None)."""
    every = slice(None)
    return {f"layer_{layer}": route_agreement(
                got[layer][every if got_rows is None else got_rows].cpu(),
                ref[layer][every if ref_rows is None else ref_rows].cpu(),
                experts)
            for layer in sorted(ref)}


@contextlib.contextmanager
def fp32_matmuls():
    """fp32 products in fp32 (no TF32) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def moe_impl_checks(params: dict, tc: TargetConfig, ids, mask, layers,
                    stream: torch.Tensor, fp32: tuple, fp32_routes: dict
                    ) -> dict:
    """``moe_impl="dense"`` against ``gathered`` on an fp32 batch, with no
    TF32. Each MoE layer alone, fed the residual stream the gathered fp32
    run fed it (``stream``: every layer's output, the embedding first):
    both impls route every token alike and agree within ``MOE_IMPL_TOL``.
    The whole forward through ``dense`` against the gathered run's
    captures (``fp32``, over the real tokens) is reported, not held: the
    two impls' rounding differences reach the later layers' routers and
    flip near-tied choices there. A deepseek-style target (its layers cut
    out one at a time as a one-layer MoE target)."""
    if tc.moe_variant != "deepseek":
        raise ValueError(f"{tc.moe_variant!r}: one-layer cuts take a "
                         "deepseek-style target")
    h = tc.hidden_size
    experts = tc.num_experts + tc.zero_expert_num
    valid = mask.bool().cpu()
    one = dataclasses.replace(tc, num_hidden_layers=1,
                              first_k_dense_replace=0)
    per_layer = {}
    with fp32_matmuls():
        for i in range(tc.num_hidden_layers):
            if not tc.is_moe_layer(i):
                continue
            prefix = f"model.layers.{i}."
            cut = {k.replace(prefix, "model.layers.0."): v
                   for k, v in params.items() if k.startswith(prefix)}
            cut.update({k: params[k] for k in ("model.embed_tokens.weight",
                                               "model.norm.weight")})
            runs = {}
            for impl in ("gathered", "dense"):
                routing = {}
                out, _ = target_capture_forward(
                    cut, one, ids, mask, (0,), compute_dtype=torch.float32,
                    moe_impl=impl, routing=routing,
                    inputs_embeds=stream[..., i * h:(i + 1) * h])
                runs[impl] = (out.cpu()[valid], routing[0])
            (got, got_route), (ref, ref_route) = runs["dense"], \
                runs["gathered"]
            check(f"layer {i} alone, dense vs gathered routing (differing)",
                  0.0 if torch.equal(got_route, ref_route) else 1.0, 0.0)
            excess = float(((got - ref).abs()
                            - MOE_IMPL_TOL * (1 + ref.abs())).max())
            check(f"layer {i} alone, dense vs gathered (|d - g| - "
                  f"{MOE_IMPL_TOL} * (1 + |g|))", excess, 0.0)
            per_layer[f"layer_{i}"] = max_err(got, ref)
        routes = {}
        dense = target_capture_forward(
            params, tc, ids, mask, layers, compute_dtype=torch.float32,
            moe_impl="dense", routing=routes)
    dense = tuple(t.cpu()[valid] for t in dense)
    rows = valid.reshape(-1).to(ids.device)
    return {"layers_alone_max_abs_err": per_layer,
            "whole_route_agreement": route_agreements(
                routes, fp32_routes, experts, rows, rows),
            "whole_rel_l2": capture_errors(dense, fp32, layers, h)}


def capture_phase(cfg_path: Path, device, seed: int, workdir: Path, *,
                  target_config=QWEN3_8B_TARGET, depth=None,
                  max_length=MAX_LEN, min_len=1536, batch=CAPTURE_BATCH,
                  std=TARGET_STD, n_train=TRAIN_FILES, n_eval=EVAL_FILES,
                  capture_layers=None, shard_layers=SHARD_LAYERS,
                  ref_path: Optional[Path] = None) -> tuple:
    """Slices 16 and 17's capture: a random target of ``target_config``
    (cut to ``depth`` layers) written as an HF directory; conversations
    from the seed rendered by the qwen template and parser
    (``build_dataset``) with ``SpreadTokenizer``; the eagle layout captured
    at the draft's default layers (or ``capture_layers``) through the
    runner (``moe_impl="gathered"``) and ``prepare.capture`` into
    ``workdir``'s train and eval directories, with the vocab mapping
    derived from the captured ids. Checks: every captured tensor finite;
    the files read back through the data plane (manifest and store) in the
    right shapes with the parser's ids and loss masks; a sample captured
    alone against its row of a padded batch, and one batch's bf16 capture
    against an fp32 run of the same forward (``CAPTURE_REL_L2``). An MoE
    target's routing is recorded in those runs: the share of (token,
    expert) assignments each MoE layer's bf16 run and lone sample agree on
    with the fp32 run and the batch (at least ``MOE_ROUTE_AGREEMENT``),
    and ``moe_impl="dense"`` against ``gathered`` (``moe_impl_checks``).
    ``ref_path``: the first padded batch's one-process reference for the
    capture-mesh phase is saved there (``save_capture_reference``) →
    (results, what the training phase reads)."""
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    config = dict(target_config)
    if depth is not None:
        config["num_hidden_layers"] = depth
    t0 = time.perf_counter()
    target = write_capture_target(workdir / "target", config, device, seed,
                                  std, shard_layers)
    results = {"target": {k: config[k] for k in TARGET_FIELDS
                          if k in config},
               "target_bytes": sum(p.stat().st_size
                                   for p in target.iterdir()),
               "target_write_s": time.perf_counter() - t0}

    # conversations → the qwen template and parser
    t0 = time.perf_counter()
    tokenizer = SpreadTokenizer(config["vocab_size"])
    records = synthetic_conversations(n_train + n_eval, tokenizer, seed,
                                      min_len, max_length)
    parsed = build_dataset(records, tokenizer, "qwen", max_length)
    if len(parsed) != n_train + n_eval:
        raise AssertionError(f"{len(parsed)} supervised samples of "
                             f"{n_train + n_eval} conversations")
    samples = [{"input_ids": p.input_ids, "loss_mask": p.loss_mask}
               for p in parsed]
    parts = [(name, part) for name, part in (("train", samples[:n_train]),
                                             ("eval", samples[n_train:]))
             if part]
    results["tokenize_s"] = time.perf_counter() - t0

    # the runner holds the target; prepare.capture applies the capture-
    # layer rule and writes each set of files
    providers = builtin_algorithm_registry().resolve("eagle3").providers
    layers = providers.resolve_capture_layers(
        Eagle3Config.from_file(cfg_path), config["num_hidden_layers"],
        capture_layers)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    runner = OfflineCaptureRunner(
        OfflineCaptureConfig(str(target), str(workdir / "train"), layers,
                             max_length, batch),
        moe_impl="gathered", device=None if on_card else device)
    sync()
    results["target_load_s"] = time.perf_counter() - t0
    tc = runner.target_config
    written, capture_s = {}, 0.0
    for name, part in parts:
        t0 = time.perf_counter()
        out = prepare.capture(
            part, target_model=str(target), output_dir=str(workdir / name),
            algorithm="eagle3", draft_config=str(cfg_path),
            capture_layers=capture_layers, max_length=max_length,
            batch_size=batch, runner=runner)
        sync()
        capture_s += time.perf_counter() - t0
        written[name] = out
    if tuple(written["train"].capture_layers) != tuple(layers):
        raise AssertionError(f"capture layers {written['train']} != {layers}")
    real = sum(len(s["input_ids"]) for s in samples)
    results.update({
        "capture_layers": list(layers), "batch": batch,
        "moe_impl": runner.moe_impl,
        "samples": len(samples), "real_tokens": real,
        "sample_lengths": [len(s["input_ids"]) for s in samples],
        "capture_s": capture_s,
        "capture_tokens_per_s": real / capture_s,
    })

    # one padded batch: the forward alone, timed, and its fp32 run
    ids = np.zeros((batch, max_length), np.int64)
    mask = np.zeros((batch, max_length), np.int64)
    for j, s in enumerate(samples[:batch]):
        ids[j, :len(s["input_ids"])] = s["input_ids"]
        mask[j, :len(s["input_ids"])] = 1
    times = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        bf16 = runner._run_batch(ids, mask)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    results["forward_ms"] = statistics.median(times)
    results["forward_padded_tokens_per_s"] = batch * max_length / (
        results["forward_ms"] / 1e3)
    if on_card:
        results["peak_bytes"] = torch.cuda.max_memory_allocated()
    moe = tc.num_experts > 0
    ids_t = torch.as_tensor(ids, device=runner.device)
    mask_t = torch.as_tensor(mask, device=runner.device)
    valid = torch.as_tensor(mask, dtype=torch.bool)
    routes = {"bf16": {}, "fp32": {}, "alone": {}}
    experts = tc.num_experts + tc.zero_expert_num
    # an MoE target's fp32 run keeps every layer's output: each MoE
    # layer's input for the dense-vs-gathered check
    every = tuple(range(-1, tc.num_hidden_layers)) if moe else layers
    if moe:  # the bf16 batch's routing, in the runner's forward once more
        target_capture_forward(runner.params, tc, ids_t, mask_t, layers,
                               routing=routes["bf16"])
    with fp32_matmuls():
        stream, last = target_capture_forward(
            runner.params, tc, ids_t, mask_t, every,
            compute_dtype=torch.float32, routing=routes["fp32"])
    h = config["hidden_size"]
    slots = [every.index(layer) for layer in layers]
    fp32 = (torch.cat([stream[..., j * h:(j + 1) * h] for j in slots],
                      dim=-1).cpu()[valid], last.cpu()[valid])
    errors = capture_errors(tuple(t[valid] for t in bf16), fp32, layers, h)
    for name, err in errors.items():
        check(f"bf16 capture vs fp32, {name} (relative L2)", err,
              CAPTURE_REL_L2)
    results["bf16_vs_fp32_rel_l2"] = errors
    if moe:
        results["dense_vs_gathered"] = moe_impl_checks(
            runner.params, tc, ids_t, mask_t, layers, stream, fp32,
            routes["fp32"])
        rows = valid.reshape(-1).to(runner.device)
        agreement = route_agreements(routes["bf16"], routes["fp32"],
                                     experts, rows, rows)
        for name, share in agreement.items():
            check(f"bf16 vs fp32 routing agreement, {name} (1 - share)",
                  1.0 - share, 1.0 - MOE_ROUTE_AGREEMENT)
        results["bf16_vs_fp32_route_agreement"] = agreement
    del fp32, stream, last

    # the first sample alone (one row, its own length) against its file
    n0 = len(samples[0]["input_ids"])
    alone = OfflineCaptureRunner(
        OfflineCaptureConfig(str(target), str(workdir / "alone"), layers,
                             n0, 1),
        target_config=tc, target_params=runner.params, moe_impl="gathered")
    if moe:
        target_capture_forward(
            runner.params, tc,
            torch.as_tensor(samples[0]["input_ids"][None],
                            device=runner.device), None, layers,
            routing=routes["alone"])
        agreement = route_agreements(routes["alone"], routes["bf16"],
                                     experts, ref_rows=slice(0, n0))
        for name, share in agreement.items():
            check(f"sample alone vs its padded row, routing agreement, "
                  f"{name} (1 - share)", 1.0 - share,
                  1.0 - MOE_ROUTE_AGREEMENT)
        results["alone_vs_batch_route_agreement"] = agreement
    alone = alone._run_batch(samples[0]["input_ids"][None], np.ones((1, n0)))
    stored, _ = load_feature_file(str(workdir / "train" /
                                      "sample-000000.sft"))
    errors = capture_errors((alone[0][0], alone[1][0]),
                            (stored["hidden_state"], stored["target"]),
                            layers, config["hidden_size"])
    for name, err in errors.items():
        check(f"sample alone vs its padded row, {name} (relative L2)", err,
              CAPTURE_REL_L2)
    results["alone_vs_batch_rel_l2"] = errors
    if ref_path is not None:
        save_capture_reference(runner, ids, mask, ref_path)
    del runner, alone, bf16, routes
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # read back through the data plane: the manifest, the file store
    store = FileFeatureStore()
    h = config["hidden_size"]
    checked = 0
    for name, part in parts:
        refs = [FileFeatureStore.ref_for_file(path, read_specs=True)
                for path in OfflineManifestReader(
                    str(workdir / name)).list_files()]
        if len(refs) != len(part):
            raise AssertionError(f"{name}: {len(refs)} files, expected "
                                 f"{len(part)}")
        for ref, sample in zip(refs, part):
            n = len(sample["input_ids"])
            shapes = {k: tuple(f.spec.shape) for k, f in ref.features.items()}
            want = {"input_ids": (n,), "loss_mask": (n,),
                    "hidden_state": (n, len(layers) * h), "target": (n, h)}
            if shapes != want:
                raise AssertionError(f"{ref.sample_id}: shapes {shapes}, "
                                     f"expected {want}")
            if ref.metadata.get("capture_layers") != ",".join(
                    map(str, layers)):
                raise AssertionError(f"{ref.sample_id}: metadata "
                                     f"{dict(ref.metadata)}")
            tensors = store.fetch(ref)
            for key in ("hidden_state", "target"):
                if tensors[key].dtype != torch.bfloat16 or not bool(
                        torch.isfinite(tensors[key]).all()):
                    raise AssertionError(f"{ref.sample_id}: {key} not "
                                         "finite bf16")
            if not (np.array_equal(tensors["input_ids"].numpy(),
                                   sample["input_ids"])
                    and np.array_equal(tensors["loss_mask"].numpy(),
                                       sample["loss_mask"])):
                raise AssertionError(f"{ref.sample_id}: ids or loss mask "
                                     "differ from the parser's")
            checked += 1
    results["files_checked"] = checked

    mapping = Path(written["train"].vocab_mapping_path)
    t2d, _ = load_vocab_mapping(str(mapping))
    seen = np.unique(np.concatenate([s["input_ids"]
                                     for s in samples[:n_train]]))
    results["vocab"] = {
        "distinct_ids": int(seen.size),
        "id_range": [int(seen.min()), int(seen.max())],
        "draft_ids_seen": int(t2d[seen].sum()),
        "draft_vocab": int(t2d.sum())}
    return results, {"target": target, "vocab_mapping": mapping,
                     "capture_layers": layers}


def check_exports(runs: Path, step_dir: Path, cfg_path: Path, target: Path,
                  out: Path, device) -> dict:
    """Slice 16's export: ``cli export`` of the run root (its final
    checkpoint) to the SGLang layout, and ``export_to_hf`` with the target
    as ``embedding_source``; the required keys and ``config.json`` (the
    draft config) of each; every weight read back through
    ``draft_state_from_export`` bit-identical to the checkpoint's cast to
    bf16, the vocab buffers equal, the HF embedding the target's. The
    SGLang export is left in ``out / "sglang"``."""
    on_card = device.type == "cuda"
    saved = CheckpointManager.load_state(str(step_dir))
    prefix = "draft_model."
    params = {k[len(prefix):]: v for k, v in saved["params"].items()}
    buffers = {k[len(prefix):]: v for k, v in saved["buffers"].items()}
    draft_cfg = json.loads(cfg_path.read_text())
    results = {"from": step_dir.name}
    t0 = time.perf_counter()
    rc = cli.main(["export", str(runs), "-o", str(out / "sglang"), "--to",
                   "sglang", "--draft-config", str(cfg_path),
                   *([] if on_card else ["--device", str(device)])])
    results["sglang_s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli export exited {rc}")
    t0 = time.perf_counter()
    export_to_hf(str(runs), str(out / "hf"), draft_config_path=str(cfg_path),
                 embedding_source=str(target),
                 device=None if on_card else device)
    results["hf_s"] = time.perf_counter() - t0
    for fmt in ("sglang", "hf"):
        tensors, _ = load_feature_file(str(out / fmt / "model.safetensors"))
        missing = [k for k in REQUIRED_SGLANG_KEYS if k not in tensors]
        check(f"{fmt} export: required keys missing", float(len(missing)),
              0.0)
        config = json.loads((out / fmt / "config.json").read_text())
        check(f"{fmt} export: config.json differs from the draft config",
              0.0 if config == draft_cfg else 1.0, 0.0)
        loaded = draft_state_from_export(tensors, {**params, **buffers})
        differing = [n for n, v in params.items() if n not in loaded
                     or not torch.equal(loaded[n],
                                        v.to(torch.bfloat16).to(v.dtype))]
        differing += [n for n, v in buffers.items()
                      if not torch.equal(loaded[n], v)]
        check(f"{fmt} export: tensors differing from the checkpoint's in "
              "bf16", float(len(differing)), 0.0)
        not_bf16 = [k for k, v in tensors.items()
                    if v.is_floating_point() and v.dtype != torch.bfloat16]
        check(f"{fmt} export: floating tensors not bf16",
              float(len(not_bf16)), 0.0)
        if fmt == "hf":
            embed = TargetHead.from_pretrained(
                str(target), lm_head_key="model.embed_tokens.weight").weight
            check("hf export: embedding differs from the target's",
                  0.0 if torch.equal(tensors["embed_tokens.weight"], embed)
                  else 1.0, 0.0)
        elif "embed_tokens.weight" in tensors:
            raise AssertionError("sglang export carries an embedding")
        results[fmt] = {
            "tensors": len(tensors),
            "bytes": (out / fmt / "model.safetensors").stat().st_size,
            "bit_identical": True}
    # the SGLang export stays for the serving phase
    shutil.rmtree(out / "hf")
    return results


# --------------------------------------------------------------------------
# slice 19: chain speculative serving of the captured target with the
# training phase's SGLang export
# --------------------------------------------------------------------------

#: prompts cut from the phase's eval conversations, their lengths drawn
#: from the seed, and the tokens each decodes
SERVING_PROMPTS = 4
SERVING_PROMPT_LEN = (256, 1024)
SERVING_NEW_TOKENS = 64
#: draft tokens a round and the cache budget (serving_server_main's
#: defaults)
SERVING_K, SERVING_MAX_LEN = 4, 2048
#: the server's request: the first prompt cut to this many tokens
SERVING_SERVER_PROMPT, SERVING_SERVER_NEW = 256, 32
#: seconds the served subprocess may take to print READY (the target's
#: load included), and to stop
SERVING_READY_TIMEOUT, SERVING_STOP_TIMEOUT = 300, 30
#: bf16 serving may leave greedy decoding only at near-ties: every token
#: a decoder emits lies at most this many bf16 ulps (of the top-1 logit)
#: below the top-1 of greedy's step along the decoder's own output
#: (``departures``). The (k+1)-token verify and the 1-token step sum in
#: other orders: over 756 positions of 12 prompts on 4 random 36-layer
#: Qwen3-8B-shaped targets (``--serving-gaps``, one H100) their rounding
#: moved the margin of greedy's token by 7 ulps at most (5 at the 99th
#: percentile), the verify's argmax lay at most 6 ulps below greedy's
#: top-1 and the chain decoder's tokens at most 5; with a RoPE position
#: one ahead or a stale cache slot planted, the argmax lay a median of 68
#: and 164 ulps below it, past 8 at 718 and 744 of the 756 positions and
#: in every prompt. Eight sits above the sound spread and an order of
#: magnitude below a fault's
SERVING_TIE_ULPS = 8


def serving_prompts(eval_dir: Path, n: int, seed: int, lo: int, hi: int
                    ) -> list:
    """``n`` prompts cut from the eval conversations' token ids, each to a
    length drawn from [lo, hi] (and at most the conversation's)."""
    rng = np.random.default_rng(seed + 19)
    prompts = []
    for path in sorted(eval_dir.glob("*.sft"))[:n]:
        ids, _ = load_feature_file(str(path))
        ids = ids["input_ids"].tolist()
        prompts.append(ids[:min(len(ids), int(rng.integers(lo, hi + 1)))])
    if len(prompts) != n:
        raise AssertionError(f"{len(prompts)} eval conversations for {n} "
                             "serving prompts")
    return prompts


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def greedy_logits(params, config, prompt, new_tokens: int, max_len: int,
                  forced=None) -> tuple:
    """``spec_decode.greedy_target_decode``'s loop, keeping each step's
    logits → (tokens, logits [new_tokens, V]). With ``forced`` (tokens),
    each step feeds the next of them in place of its own argmax: row j is
    greedy's step after ``prompt`` and ``forced[:j]``."""
    device = params["model.embed_tokens.weight"].device
    state = spec_decode.init_target_state(config, 1, max_len, device=device)
    ids = torch.tensor([prompt], device=device)
    out, rows, length = list(prompt), [], len(prompt)
    ck, cv = state.cache_k, state.cache_v
    for j in range(new_tokens):
        logits, _, ck, cv = spec_decode.target_cached_forward(
            params, config, ids, ck, cv, length - ids.shape[1], ())
        rows.append(logits[0, -1])
        # ties: the first index
        out.append(int(logits[0, -1].argmax()) if forced is None
                   else int(forced[j]))
        ids = torch.tensor([[out[-1]]], device=device)
        length += 1
    return np.asarray(out), torch.stack(rows)


def excess_ulps(rows: torch.Tensor, tokens) -> list:
    """How far each token's logit lies below its row's top-1, in bf16 ulps
    of the top-1 (0 for the argmax)."""
    rows = rows.float()
    top = rows.max(dim=-1).values.tolist()
    got = rows.gather(1, torch.as_tensor(tokens, device=rows.device)[:, None]
                      )[:, 0].tolist()
    return [(t - g) / bf16_ulp(t) for t, g in zip(top, got)]


def departures(params, config, prompt, output_ids, new_tokens: int,
               max_len: int) -> tuple:
    """A decoder's first ``new_tokens`` new tokens held to greedy decoding
    along its own output (``greedy_logits`` forced) → (the tokens before
    the first that is not its step's argmax, where its prefix is greedy's
    own output, or None; each token's ``excess_ulps``)."""
    new = [int(t) for t in output_ids[len(prompt):len(prompt) + new_tokens]]
    _, rows = greedy_logits(params, config, prompt, len(new), max_len,
                            forced=new)
    best = rows.argmax(dim=-1).tolist()
    first = next((j for j, (b, t) in enumerate(zip(best, new)) if b != t),
                 None)
    return first, excess_ulps(rows, new)


def first_difference(got, want) -> Optional[int]:
    n = min(len(got), len(want))
    diff = np.flatnonzero(np.asarray(got[:n]) != np.asarray(want[:n]))
    return int(diff[0]) if diff.size else None


class ServedProcess:
    """``python -m specforge_tpu_torch.inference.serving_server_main`` on a
    target and an export (bf16, the card unless ``device`` is the CPU;
    ``family`` "dflash" for a block draft, which takes no ``k``), started
    at once: ``ask`` waits for its READY line, then reads ``/health`` and
    posts each request; ``stop`` ends the process either way."""

    def __init__(self, target: Path, export: Path, device,
                 k: Optional[int], max_len: int, family: str = "eagle3"):
        self.port = free_port()
        cmd = [sys.executable, "-m",
               "specforge_tpu_torch.inference.serving_server_main",
               "--family", family, "--target", str(target), "--export",
               str(export), "--max-len", str(max_len),
               "--port", str(self.port)]
        if k is not None:
            cmd += ["--draft-tokens", str(k)]
        if device.type != "cuda":
            cmd += ["--device", str(device)]
        self.command = " ".join(cmd[2:])
        # this process's thread count, so a CPU run sums in the same order
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   OMP_NUM_THREADS=str(torch.get_num_threads()))
        self.t0 = time.perf_counter()
        self.lines, self.ready_s = [], None
        self._ready = threading.Event()
        self.proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            if line.startswith("READY port="):
                self.ready_s = time.perf_counter() - self.t0
                self._ready.set()

    def wait_ready(self) -> None:
        if not self._ready.wait(SERVING_READY_TIMEOUT):
            raise AssertionError("the serving server printed no READY line "
                                 f"in {SERVING_READY_TIMEOUT} s: "
                                 + " | ".join(self.lines[-20:]))

    def ask(self, requests: list) -> dict:
        self.wait_ready()
        url = f"http://127.0.0.1:{self.port}"
        return {"command": self.command, "ready_s": self.ready_s,
                "health": http_json(f"{url}/health"),
                "answers": [http_json(f"{url}/generate", body)
                            for body in requests]}

    def stop(self) -> int:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=SERVING_STOP_TIMEOUT)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=SERVING_STOP_TIMEOUT)
        self._reader.join(timeout=SERVING_STOP_TIMEOUT)
        return self.proc.returncode


def serving_phase(captured: dict, export: Path, workdir: Path, seed: int,
                  device, *, n_prompts=SERVING_PROMPTS,
                  prompt_len=SERVING_PROMPT_LEN,
                  new_tokens=SERVING_NEW_TOKENS, k=SERVING_K,
                  max_len=SERVING_MAX_LEN,
                  server_prompt=SERVING_SERVER_PROMPT,
                  server_new=SERVING_SERVER_NEW) -> dict:
    """Slice 19 on the capture phase's target and the training phase's
    SGLang export, through ``serving_loaders`` and the chain decoder (the
    target's bf16 weights read once; the fp32 ones are their exact
    upcast):

    1. and 2. ``serving_checks`` in full, every prompt in fp32 too;
    3. ``serving_server_main`` as a process on the same files (started
       first, so it loads while 1 runs): ``/health`` and one chain and one
       ``plain`` ``/generate`` equal to this process's decoder."""
    on_card = device.type == "cuda"
    layers = tuple(captured["capture_layers"])
    prompts = serving_prompts(workdir / "eval", n_prompts, seed, *prompt_len)
    results = {"prompt_lengths": [len(p) for p in prompts],
               "new_tokens": new_tokens, "num_draft_tokens": k,
               "max_len": max_len, "capture_layers": list(layers)}
    server = ServedProcess(captured["target"], export, device, k, max_len)
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, config, draft = load_spec_models(
            str(captured["target"]), str(export), device=device)
        n = config.num_hidden_layers
        if layers != (1, n // 2 - 1, n - 4):
            raise AssertionError(f"capture layers {list(layers)} are not the "
                                 "serving loaders' default rule")
        results["load_s"] = time.perf_counter() - t0
        checks, decoder = serving_checks(
            (params, config), draft, prompts, device, new_tokens, max_len,
            fp32_prompts=[(p, new_tokens) for p in prompts], k=k,
            before_timing=server.wait_ready)
        del draft
        results.update(checks)
        # 3. the server process against this process's decoder
        params, config = decoder.target_params, decoder.target_config
        server_ids = prompts[0][:server_prompt]
        want_chain = decoder.generate_fused(server_ids, server_new)
        want_plain = spec_decode.fused_plain_decode(
            params, config, server_ids, server_new, max_len=max_len,
            loop_cache=decoder.plain_loops)
        del decoder, params, config
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        body = {"input_ids": server_ids, "max_new_tokens": server_new}
        served = server.ask([body, {**body, "plain": True}])
    finally:
        served_rc = server.stop()
    chain, plain = served.pop("answers")
    if (chain["output_ids"] != want_chain.output_ids.tolist()
            or chain["accept_lengths"] != want_chain.accept_lengths
            or plain["output_ids"] != want_plain.tolist()):
        raise AssertionError("the server's /generate differs from this "
                             "process's decoder")
    health = served["health"]
    if (health["status"] != "ok" or health["num_draft_tokens"] != k
            or health["counters"]["requests"] != 0):
        raise AssertionError(f"the server's /health: {health}")
    served.update(exit_code=served_rc, outputs_equal=True,
                  chain_wall_ms=chain["wall_ms"],
                  plain_wall_ms=plain["wall_ms"],
                  chain_mean_accept_length=chain["mean_accept_length"])
    results["server"] = served
    return results


def serving_checks(target: tuple, draft, prompts: list, device,
                   new_tokens: int, max_len: int, *, fp32_prompts: list,
                   full: bool = True, k: Optional[int] = None,
                   before_timing=lambda: None) -> tuple:
    """The decoder over ``target`` (bf16 params, config) and ``draft``: the
    EAGLE3 chain decoder with ``k`` draft tokens a round, else (``k`` None)
    the DFlash-family block decoder → (results, the bf16 decoder).

    1. fp32, no TF32, on ``fp32_prompts`` ((prompt, new tokens) pairs):
       ``greedy_target_decode``, ``fused_plain_decode`` (``full``),
       ``generate`` and ``generate_fused`` emit the same tokens (the first
       new tokens; a round may run past them), and the two speculative paths
       the same accept lengths;
    2. bf16 (the serving dtype) on every prompt (``full``, else the first):
       the prefill, ``generate_fused`` beside ``fused_plain_decode``
       (``full``; rounds/s, tokens/s, accept lengths), the graph replays
       against the rounds and plain token steps, the agreement with greedy
       decoding (``departures``: every token at most ``SERVING_TIE_ULPS``
       below greedy's top-1 along the decoder's own output), peak memory
       (since the caller's reset) and (``full``) one round's device ops
       under torch.profiler. A block
       decoder also gives the DFlash forward's launches (the warm-up runs
       and the capture counted by its wrapper, then one a draft layer each
       replay) and its fp32 head copy's cost.

    ``before_timing()`` runs before the first timed call."""
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    block = k is None
    params, config = target
    build = {} if block else {"num_draft_tokens": k}
    results = {}

    # 1. fp32: every decoder emits greedy decoding's tokens
    t0 = time.perf_counter()
    with fp32_matmuls():
        params32 = {name: v.float() if v.is_floating_point() else v
                    for name, v in params.items()}
        decoder = build_decoder((params32, config, draft), max_len=max_len,
                                device=device, **build)
        rows = []
        for prompt, n_new in fp32_prompts:
            want = spec_decode.greedy_target_decode(
                params32, config, prompt, n_new, max_len=max_len)
            host = decoder.generate(prompt, n_new)
            fused = decoder.generate_fused(prompt, n_new)
            got = [("generate", host.output_ids),
                   ("generate_fused", fused.output_ids)]
            if full:
                got.append(("fused_plain_decode", spec_decode.fused_plain_decode(
                    params32, config, prompt, n_new, max_len=max_len,
                    loop_cache=decoder.plain_loops)))
            for name, ids in got:
                at = first_difference(ids, want)
                if at is not None or len(ids) < len(want):
                    raise AssertionError(
                        f"fp32 {name} leaves greedy decoding at token {at} "
                        f"of a {len(prompt)}-token prompt")
            if (fused.accept_lengths != host.accept_lengths
                    or not np.array_equal(fused.output_ids, host.output_ids)):
                raise AssertionError("fp32 generate_fused differs from the "
                                     "host loop generate")
            rows.append({"prompt_length": len(prompt), "new_tokens": n_new,
                         "rounds": host.steps,
                         "mean_accept_length": host.mean_accept_length})
        del decoder, params32
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    results["fp32"] = {"decoders_equal": True, "prompts": rows,
                       "seconds": time.perf_counter() - t0}

    # 2. bf16: times, replays, agreement, memory, a round's device ops
    fwd = dflash_attention_cuda.dflash_flash_attention_fwd
    fwd.launches = 0
    decoder = build_decoder((params, config, draft), max_len=max_len,
                            device=device, **build)
    before_timing()
    # first calls: each builds its program (on the card a CUDA graph)
    sync()
    t0 = time.perf_counter()
    decoder.generate_fused(prompts[0][:64], 8)
    if full:
        spec_decode.fused_plain_decode(params, config, prompts[0][:64], 8,
                                       max_len=max_len,
                                       loop_cache=decoder.plain_loops)
    sync()
    results["first_calls_s"] = time.perf_counter() - t0
    if block:
        program, state = decoder._fused.block(max_len)
        buffers = (state.t_ck, state.t_cv, state.ctx)
    else:
        program, state = decoder._fused.chain(max_len)
        buffers = (state.t_ck, state.t_cv, state.d_ck, state.d_cv)
    first_replays = decoder._fused.replays
    decoder._fused.replays = spec_decode.fused_plain_decode.replays = 0
    rows, rounds, plain_steps = [], 0, 0
    for prompt in prompts if full else prompts[:1]:
        sync()
        t0 = time.perf_counter()
        decoder._prefill_device(np.asarray([prompt]), *buffers)
        sync()
        prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        spec = decoder.generate_fused(prompt, new_tokens)
        sync()
        spec_s = time.perf_counter() - t0
        spec_new = len(spec.output_ids) - len(prompt)
        row = {"prompt_length": len(prompt), "prefill_ms": prefill * 1e3,
               "rounds": spec.steps,
               "mean_accept_length": spec.mean_accept_length,
               "spec_new_tokens": spec_new, "spec_ms": spec_s * 1e3,
               "rounds_per_s": spec.steps / (spec_s - prefill),
               "spec_tokens_per_s": spec_new / (spec_s - prefill)}
        outputs = [("spec", spec.output_ids)]
        if full:
            t0 = time.perf_counter()
            plain = spec_decode.fused_plain_decode(
                params, config, prompt, new_tokens, max_len=max_len,
                loop_cache=decoder.plain_loops)
            sync()
            plain_s = time.perf_counter() - t0
            row.update(plain_ms=plain_s * 1e3,
                       plain_tokens_per_s=(len(plain) - len(prompt))
                       / (plain_s - prefill))
            outputs.append(("plain", plain))
            plain_steps += len(plain) - len(prompt) - 1
        for name, got in outputs:
            at, excess = departures(params, config, prompt, got, new_tokens,
                                    max_len)
            row[f"{name}_agreement"] = (
                len(excess) if at is None else at) / new_tokens
            row[f"{name}_max_excess_ulps"] = max(excess)
            if at is not None:
                row[f"{name}_first_difference"] = {
                    "token": at, "excess_ulps": excess[at]}
            if not max(excess) <= SERVING_TIE_ULPS:
                raise AssertionError(
                    f"bf16 {name} decoding emits a token {max(excess)} ulps "
                    "below greedy's top-1 along its own output (more than "
                    f"{SERVING_TIE_ULPS}: not a near-tie)")
        rows.append(row)
        rounds += spec.steps
    replays = decoder._fused.replays
    if on_card and (replays != rounds or (
            full and spec_decode.fused_plain_decode.replays != plain_steps)):
        raise AssertionError(
            f"graph replays {replays} for {rounds} rounds, "
            f"{spec_decode.fused_plain_decode.replays} for {plain_steps} "
            "plain token steps")
    bf16 = {
        "prompts": rows, "rounds": rounds, "graph_replays": replays,
        "graphs": on_card,
        "mean_accept_length": float(np.mean(
            [r["mean_accept_length"] for r in rows])),
        "prefill_ms": [r["prefill_ms"] for r in rows],
        "rounds_per_s": statistics.median(r["rounds_per_s"] for r in rows),
        "spec_tokens_per_s": statistics.median(
            r["spec_tokens_per_s"] for r in rows),
        "spec_agreement": float(np.mean([r["spec_agreement"]
                                         for r in rows])),
        "tie_ulps": SERVING_TIE_ULPS}
    if full:
        bf16.update(
            plain_graph_replays=spec_decode.fused_plain_decode.replays,
            plain_token_steps=plain_steps,
            plain_tokens_per_s=statistics.median(
                r["plain_tokens_per_s"] for r in rows))
    if block:
        # the wrapper counts the warm-up runs and the capture; each replay
        # launches the forward once a draft layer
        layers = draft.config.num_hidden_layers
        eager = fwd.launches
        if on_card and eager != (spec_decode.WARMUP_RUNS + 1) * layers:
            raise AssertionError(
                f"{eager} counted DFlash forward launches while the block "
                "program was built, expected "
                f"{(spec_decode.WARMUP_RUNS + 1) * layers}")
        launches = eager + layers * (first_replays + replays)
        if on_card and not launches:
            raise AssertionError("the block decoder launched no DFlash "
                                 "forward")
        bf16.update(draft_layers=layers, dflash_fwd_launches={
            "counted_eager": eager,
            "replayed": layers * (first_replays + replays),
            "total": launches})
    if on_card:
        bf16["peak_bytes"] = torch.cuda.max_memory_allocated()
        if block:
            head = decoder._lm_head
            hidden = torch.randn(1, decoder.block_size, head.shape[1],
                                 device=device).to(torch.bfloat16)
            bf16["lm_head_fp32_copy"] = {
                "choice": "one fp32 copy of the target's head, made at "
                          "construction: JAX's fp32 product every round, "
                          "no upcast a round",
                "bytes": head.numel() * head.element_size(),
                "product_ms": median_ms(lambda: F.linear(hidden.float(),
                                                         head)),
                "bf16_product_ms": median_ms(lambda: F.linear(
                    hidden, params["lm_head.weight"]))}
        if full:
            # one more round (the last request's state) under the profiler
            bf16["one_round_profile"] = profile_device(
                lambda: (program(), sync()), top=12)
    results["bf16"] = bf16
    return results, decoder


def emit_serving(results: dict, depth: int) -> None:
    full = QWEN3_8B_TARGET["num_hidden_layers"]
    emit({"phase": "serving",
          "command": "python -m specforge_tpu_torch.inference."
                     "serving_server_main --target T --export E",
          "target": "the capture phase's", "draft": "the training phase's "
          "SGLang export (configs/qwen3-8b-eagle3.json)",
          "nvidia_smi": subprocess.run(
              ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"], capture_output=True,
              text=True).stdout.strip(),
          "reduced": {
              "weights": f"random, from --seed (std {TARGET_STD}); the draft "
                         "trained 2 steps on their features",
              "depth": None if depth == full else
              f"{depth} of {full} target layers (the capture phase's "
              "target; --capture-only serves all 36)",
              "prompts": f"{SERVING_PROMPTS} prompts of "
                         f"{SERVING_PROMPT_LEN[0]}-{SERVING_PROMPT_LEN[1]} "
                         "tokens cut from the eval conversations, "
                         f"{SERVING_NEW_TOKENS} new tokens each"},
          "tolerances": {"fp32": "tokens equal", "bf16_tie_ulps":
                         SERVING_TIE_ULPS},
          **results})


# --------------------------------------------------------------------------
# DFlash-family block serving on dflash-layout features
# --------------------------------------------------------------------------

#: DFlash and DSpark: one prompt in bf16, and an fp32 host loop against the
#: fused rounds on the first prompt cut to this many tokens
BLOCK_SHORT_PROMPT, BLOCK_SHORT_NEW = 128, 24
#: Domino's fp32 check: the first prompt (all 4 took 27 s on one H100)
BLOCK_FP32_PROMPTS = 1
#: the family phases that train on the block phase's dflash-layout capture
#: and its target (in this order; DSpark at blocks of 7 needs a Qwen3-4B
#: width and keeps its own run)
BLOCK_FAMILIES = ("domino", "dspark", "dflash")
#: the DFlash forward at the serving shape: one anchor over the budget
#: (B 1, H 32 / KVH 8, D 128, S = SERVING_MAX_LEN), blocks of 16 and of 7;
#: None stands for S - bs - 1, the last anchor a round can have
BLOCK_KERNEL_ANCHORS = (1, 63, 64, 65, 1024, None)
BLOCK_KERNEL_BLOCKS = (16, 7)
BLOCK_KERNEL_HEADS = (32, 8, 128)


def depth_draft_config(cfg_path: Path, depth: int, out: Path) -> Path:
    """``cfg_path`` with its capture layers by the evenly spaced rule at a
    target of ``depth`` layers (``build_target_layer_ids``: the config's own
    ids at 36, repeated ids at 6), written to ``out``."""
    raw = json.loads(Path(cfg_path).read_text())
    n = len(DFlashConfig.from_dict(raw).resolved_target_layer_ids)
    raw["num_target_layers"] = depth
    raw.setdefault("dflash_config", {})["target_layer_ids"] = (
        build_target_layer_ids(depth, n))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(raw, indent=2))
    return out


def dflash_capture(captured: dict, workdir: Path, cfg_path: Path, device,
                   max_length: int, batch: int) -> dict:
    """The capture phase's train conversations (read back from its eagle
    files, in their order, so the batches are the same) captured again in
    the dflash layout through ``prepare.capture`` at ``cfg_path``'s layers,
    into ``workdir / "dflash"``; every column of a layer both layouts
    capture, and the last hidden state, bit-identical between them."""
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    eagle = sorted((workdir / "train").glob("*.sft"))
    samples = []
    for path in eagle:
        tensors, _ = load_feature_file(str(path))
        samples.append({"input_ids": tensors["input_ids"].numpy(),
                        "loss_mask": tensors["loss_mask"].numpy()})
    sync()
    t0 = time.perf_counter()
    out = prepare.capture(
        samples, target_model=str(captured["target"]),
        output_dir=str(workdir / "dflash"), algorithm="domino",
        draft_config=str(cfg_path), max_length=max_length, batch_size=batch,
        device=None if on_card else device)
    sync()
    capture_s = time.perf_counter() - t0
    layers = tuple(out.capture_layers)
    del out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    e_layers = tuple(captured["capture_layers"])
    shared = sorted(set(layers) & set(e_layers))
    columns = 0
    for path in eagle:
        e_t, _ = load_feature_file(str(path))
        d_t, _ = load_feature_file(str(workdir / "dflash" / path.name))
        h = e_t["target"].shape[-1]

        def block(x, j):
            return x[:, j * h:(j + 1) * h]

        for layer in shared:
            ref = block(e_t["hidden_state"], e_layers.index(layer))
            got = [block(e_t["hidden_state"], j)
                   for j, l in enumerate(e_layers) if l == layer]
            got += [block(d_t["hidden_states"], j)
                    for j, l in enumerate(layers) if l == layer]
            if not all(torch.equal(g, ref) for g in got):
                raise AssertionError(f"{path.name}: layer {layer}'s columns "
                                     "differ between the eagle and dflash "
                                     "layouts")
            columns += len(got)
        if not torch.equal(e_t["target"], d_t["target_last_hidden_states"]):
            raise AssertionError(f"{path.name}: the last hidden state "
                                 "differs between the layouts")
    real = sum(len(s["input_ids"]) for s in samples)
    return {"capture_layers": list(layers), "files": len(samples),
            "real_tokens": real, "capture_s": capture_s,
            "capture_tokens_per_s": real / capture_s,
            "eagle_capture_layers": list(e_layers), "shared_layers": shared,
            "columns_compared": columns, "bit_identical": True}


def random_block_export(kind: str, cfg_path: Path, device, seed: int,
                        root: Path) -> Path:
    """A ``kind`` draft of ``cfg_path`` with random weights from the seed,
    exported to the SGLang layout by the exporter's DFlash-family writer
    (its state handed over in memory, as a loaded checkpoint's) → the
    export's directory."""
    cfg = DFlashConfig.from_dict(json.loads(Path(cfg_path).read_text()))
    draft = DFLASH_DRAFTS[kind](cfg, dtype=torch.bfloat16, device=device,
                                seed=seed + 21)
    state = {"params": {f"draft_model.{name}": p.detach()
                        for name, p in draft.named_parameters()}}
    out = exporter._export_dflash_to_sglang(state, kind, str(root / kind),
                                            draft_config_path=str(cfg_path),
                                            device=device)
    return Path(out)


def dflash_kernel_at_serving(gen, s: int = SERVING_MAX_LEN) -> list:
    """The DFlash forward at the block decoder's shape against its plain
    version: one anchor (B 1, N 1) over a context of ``s`` keys, blocks of
    16 and 7 (the pitched copies), at ``BLOCK_KERNEL_ANCHORS``; each case
    timed beside its bound, the library's SDPA over the dense mask, and the
    CTAs it launches against the card's SMs."""
    fwd = dflash_attention_cuda.dflash_flash_attention_fwd
    h, kvh, d = BLOCK_KERNEL_HEADS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = []
    for bs in BLOCK_KERNEL_BLOCKS:
        for anchor in BLOCK_KERNEL_ANCHORS:
            a = s - bs - 1 if anchor is None else anchor

            def rnd(*shape):
                return torch.randn(*shape, generator=gen, device="cuda",
                                   dtype=torch.bfloat16)

            qkv = rnd(1, bs, (h + 2 * kvh) * d)
            q = qkv[..., :h * d].view(1, bs, h, d).transpose(1, 2)
            k_drf = qkv[..., h * d:(h + kvh) * d].view(
                1, bs, kvh, d).transpose(1, 2)
            v_drf = qkv[..., (h + kvh) * d:].view(1, bs, kvh, d).transpose(
                1, 2)
            anchors = torch.tensor([[a]], device="cuda")
            keep = torch.ones(1, 1, dtype=torch.bool, device="cuda")
            inputs = (q, rnd(1, kvh, s, d), rnd(1, kvh, s, d), k_drf, v_drf,
                      anchors, keep)
            out, m, l = fwd(*inputs, bs)
            ref, ref_m, ref_l = (
                dflash_attention_cuda.dflash_flash_attention_plain(*inputs,
                                                                   bs))
            name = f"bs{bs}_anchor{a}"
            err = rel_max_err(out, ref)
            check(f"dflash_attention_fwd at the serving shape, {name} "
                  "(max|err| / max|ref|)", err, ATTN_TOL)
            err_m = max_err(m, ref_m) / (1.0 + float(ref_m.abs().max()))
            err_l = float(((l - ref_l).abs() / ref_l.clamp(min=1e-30)).max())
            check(f"dflash m at the serving shape, {name}", err_m, STAT_RTOL)
            check(f"dflash l at the serving shape, {name}", err_l, STAT_RTOL)
            check_repeat(f"dflash_attention_fwd at the serving shape, {name}",
                         lambda: fwd(*inputs, bs))
            bound = dflash_bounds(inputs, None, bs)["dflash_attention_fwd"]
            mask = dflash_dense_mask(anchors, keep, s, bs, None)
            k_cat = torch.cat([inputs[1], k_drf], dim=2)
            v_cat = torch.cat([inputs[2], v_drf], dim=2)
            pitch = dflash_attention_cuda.block_pitch(bs)
            ctas = (-(-pitch // 64) * kvh
                    * -(-(h // kvh) // 4))
            cases.append({
                "case": name, "block_size": bs, "anchor": a, "s": s,
                "max_rel_err": err, "m_err": err_m, "l_err": err_l,
                "ms": median_ms(lambda: fwd(*inputs, bs)),
                "plain_ms": median_ms(
                    lambda: dflash_attention_cuda.dflash_flash_attention_plain(
                        *inputs, bs), runs=5),
                "library_ms": median_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k_cat, v_cat, attn_mask=mask, enable_gqa=True)),
                "bound_ms": max(bound.values()),
                "bound_by": ("bytes" if bound["bytes_ms"] >= bound["ops_ms"]
                             else "operations"),
                "ctas": ctas, "sms": sms})
    return cases


def dflash_serving_phase(captured: dict, workdir: Path, seed: int, device,
                         depth: int, *, configs=None,
                         n_prompts=SERVING_PROMPTS,
                         prompt_len=SERVING_PROMPT_LEN,
                         new_tokens=SERVING_NEW_TOKENS,
                         max_len=SERVING_MAX_LEN,
                         max_length=MAX_LEN, batch=CAPTURE_BATCH,
                         family_length=768,
                         server_prompt=SERVING_SERVER_PROMPT,
                         server_new=SERVING_SERVER_NEW,
                         family_overrides=(), on_training=None) -> tuple:
    """Block serving on the capture phase's target (``configs``: the drafts'
    config files by family, by default the repo's Qwen3-8B Domino, DSpark
    and DFlash configs):

    1. ``dflash_capture``: the capture's train conversations in the dflash
       layout at the Domino config's capture layers at this depth (the three
       configs share them);
    2. the Domino, DSpark and DFlash family phases (``run_family_training``)
       with those features and that target, Domino's and DSpark's final
       checkpoints exported by ``cli export --to sglang``;
       ``on_training(kind, results, counts)`` is called right after each
       (the script emits its ``<kind>_training`` line there);
    3. the target read once (bf16) for the three block decoders; the Domino
       export served in full (``serving_checks``), and
       ``serving_server_main --family dflash`` as a process on the same files
       (started first, so it loads while the fp32 checks run): ``/health``
       with the block size, one block and one ``plain`` ``/generate`` equal
       to this process's decoder;
    4. the DSpark export and a DFlash draft with random weights from the
       seed (the DFlash phase writes no checkpoint), exported, served the
       short way;
    5. on the card, the DFlash forward at the serving shape
       (``dflash_kernel_at_serving``)
    → (results, the family phases' results and launch counts by kind)."""
    on_card = device.type == "cuda"
    configs = configs or BLOCK_CONFIG_FILES
    drafts = {kind: depth_draft_config(path, depth,
                                       workdir / "drafts" / f"{kind}.json")
              for kind, path in configs.items()}
    layers = {kind: json.loads(path.read_text())["dflash_config"][
        "target_layer_ids"] for kind, path in drafts.items()}
    if len({tuple(v) for v in layers.values()}) != 1:
        raise AssertionError(f"the drafts read other capture layers: {layers}")
    results = {"draft_configs": {k: str(Path(p).relative_to(REPO))
                                 if Path(p).is_relative_to(REPO) else str(p)
                                 for k, p in configs.items()},
               "new_tokens": new_tokens, "max_len": max_len}
    results["capture"] = dflash_capture(captured, workdir, drafts["domino"],
                                        device, max_length, batch)
    if on_card:
        torch.cuda.empty_cache()
    exports = workdir / "exports"
    families = {}
    for kind in BLOCK_FAMILIES:
        trained, counts = run_family_training(
            kind, drafts[kind], device, seed, workdir / kind,
            max_length=family_length, overrides=family_overrides,
            features=workdir / "dflash", target=captured["target"],
            export_to=exports / kind if kind in FAMILY_CLI else None)
        families[kind] = (trained, counts)
        if on_training is not None:
            on_training(kind, trained, counts)
        if on_card:
            torch.cuda.empty_cache()
    prompts = serving_prompts(workdir / "eval", n_prompts, seed, *prompt_len)
    results["prompt_lengths"] = [len(p) for p in prompts]

    def serve(export: Path, **how) -> tuple:
        """``serving_checks`` on the export, loaded by the serving loader."""
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        draft = load_exported_draft(str(export), device=device)
        loaded = {"draft": type(draft).__name__,
                  "draft_load_s": time.perf_counter() - t0}
        checks, decoder = serving_checks(target, draft, prompts, device,
                                         new_tokens, max_len, **how)
        return {**loaded, **checks}, decoder

    server = ServedProcess(captured["target"], exports / "domino", device,
                           None, max_len, family="dflash")
    served_launches = {}
    try:
        t0 = time.perf_counter()
        config = TargetConfig.from_file(str(captured["target"]))
        target = (load_target_params(str(captured["target"]), config,
                                     dtype=torch.bfloat16, device=device),
                  config)
        results["target_load_s"] = time.perf_counter() - t0

        checks, decoder = serve(
            exports / "domino", before_timing=server.wait_ready,
            fp32_prompts=[(p, new_tokens)
                          for p in prompts[:BLOCK_FP32_PROMPTS]])
        results["domino"] = checks
        served_launches["domino"] = checks["bf16"]["dflash_fwd_launches"]
        server_ids = prompts[0][:server_prompt]
        want_block = decoder.generate_fused(server_ids, server_new)
        want_plain = spec_decode.fused_plain_decode(
            decoder.target_params, decoder.target_config, server_ids,
            server_new, max_len=max_len, loop_cache=decoder.plain_loops)
        block_size = decoder.block_size
        del decoder
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        body = {"input_ids": server_ids, "max_new_tokens": server_new}
        served = server.ask([body, {**body, "plain": True}])
    finally:
        served_rc = server.stop()
    block, plain = served.pop("answers")
    if (block["output_ids"] != want_block.output_ids.tolist()
            or block["accept_lengths"] != want_block.accept_lengths
            or plain["output_ids"] != want_plain.tolist()):
        raise AssertionError("the server's /generate differs from this "
                             "process's block decoder")
    health = served["health"]
    if (health["status"] != "ok" or health.get("block_size") != block_size
            or health["family"] != "DFlashSpecDecoder"
            or health["counters"]["requests"] != 0):
        raise AssertionError(f"the server's /health: {health}")
    served.update(exit_code=served_rc, outputs_equal=True,
                  block_wall_ms=block["wall_ms"],
                  plain_wall_ms=plain["wall_ms"],
                  block_mean_accept_length=block["mean_accept_length"])
    results["server"] = served
    t0 = time.perf_counter()
    random = random_block_export("dflash", drafts["dflash"], device, seed,
                                 exports / "random")
    results["dflash_random_export_s"] = time.perf_counter() - t0
    for kind, export in (("dspark", exports / "dspark"), ("dflash", random)):
        checks, decoder = serve(export, full=False, fp32_prompts=[
            (prompts[0][:BLOCK_SHORT_PROMPT], BLOCK_SHORT_NEW)])
        del decoder
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        results[kind] = checks
        served_launches[kind] = checks["bf16"]["dflash_fwd_launches"]
    del target
    shutil.rmtree(exports)
    results["serving_launches"] = served_launches
    if on_card:
        gen = torch.Generator(device="cuda").manual_seed(seed + 21)
        results["kernel_at_serving_shape"] = dflash_kernel_at_serving(gen)
    return results, families


def emit_family(kind: str, cfg_path: Path, results: dict, counts: dict,
                **extra) -> None:
    draft = json.loads(Path(cfg_path).read_text())
    emit({"phase": f"{kind}_training",
          "config": str(DOMINO_EXAMPLE.relative_to(REPO)),
          "draft_config": str(cfg_path.relative_to(REPO))
          if cfg_path.is_relative_to(REPO) else str(cfg_path),
          "block_size": draft["block_size"],
          "block_pitch": dflash_attention_cuda.block_pitch(
              draft["block_size"]),
          "batch": BATCH, "max_length": 768,
          "accumulation_steps": ACCUM, "launches": counts,
          "tolerances": {"step1_loss_rtol": TRAIN_STEP1_RTOL,
                         "later_loss_rtol": TRAIN_DRIFT_RTOL,
                         "grad_cosine": GRAD_COSINE,
                         "grad_norm_rtol": GRAD_NORM_RTOL},
          **extra, **results})


def block_serving_only_phase(seed: int) -> None:
    """``--block-serving-only``: the capture at ``CAPTURE_DEPTH`` layers,
    then the block serving phase (with Domino's family phase) on it."""
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        _, captured = capture_phase(CONFIG, device, seed, Path(tmp),
                                    depth=CAPTURE_DEPTH)
        torch.cuda.empty_cache()
        block, _ = dflash_serving_phase(
            captured, Path(tmp), seed, device, CAPTURE_DEPTH,
            on_training=functools.partial(emit_block_family, Path(tmp)))
        emit_dflash_serving(block, CAPTURE_DEPTH)


def emit_block_family(workdir: Path, kind: str, results: dict,
                      counts: dict) -> None:
    """The ``<kind>_training`` line of a family phase inside the block
    serving phase (Domino's time includes the dflash-layout capture before
    it)."""
    emit_family(kind, workdir / "drafts" / f"{kind}.json", results, counts,
                features="captured: the capture phase's train conversations "
                         "in the dflash layout (phase dflash_serving), on "
                         "its target",
                source_config=str(BLOCK_CONFIG_FILES[kind].relative_to(
                    REPO)))


def emit_dflash_serving(results: dict, depth: int) -> None:
    full = QWEN3_8B_TARGET["num_hidden_layers"]
    capture = results["capture"]
    emit({"phase": "dflash_serving",
          "command": "python -m specforge_tpu_torch.inference."
                     "serving_server_main --family dflash --target T "
                     "--export E",
          "target": "the capture phase's",
          "drafts": {"domino": "trained on the capture's dflash-layout "
                               "features (phase domino_training), its "
                               "SGLang export",
                     "dspark": "trained on the same features (phase "
                               "dspark_training), its SGLang export",
                     "dflash": "random weights from --seed, exported (its "
                               "phase, dflash_training, writes no "
                               "checkpoint)"},
          "nvidia_smi": subprocess.run(
              ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"], capture_output=True,
              text=True).stdout.strip(),
          "reduced": {
              "weights": f"random target, from --seed (std {TARGET_STD}); "
                         "Domino and DSpark trained by their family phases "
                         "(the domino_training and dspark_training lines) "
                         f"on the capture's {capture['files']} train "
                         "conversations cut to 768 tokens; DFlash random",
              "depth": None if depth == full else
              f"{depth} of {full} target layers (the capture phase's "
              "target; --capture-only serves all 36)",
              "capture_layers": None if depth == full else
              f"{capture['capture_layers']} by the configs' evenly spaced "
              f"rule at {depth} layers (repeated ids; "
              "configs/qwen3-8b-domino.json reads [1, 9, 17, 25, 33] of 36)",
              "prompts": f"{SERVING_PROMPTS} prompts of "
                         f"{SERVING_PROMPT_LEN[0]}-{SERVING_PROMPT_LEN[1]} "
                         "tokens cut from the eval conversations, "
                         f"{SERVING_NEW_TOKENS} new tokens each (Domino in "
                         f"fp32: the first {BLOCK_FP32_PROMPTS}; DFlash and "
                         "DSpark: the first prompt in bf16, its first "
                         f"{BLOCK_SHORT_PROMPT} tokens and "
                         f"{BLOCK_SHORT_NEW} new ones in fp32)",
              "block7": "blocks of 7 (configs/qwen3-4b-dspark.json) need a "
                        "Qwen3-4B-width target: covered by the kernel at "
                        "the serving shape and the CPU tests only"},
          "tolerances": {"fp32": "tokens equal, accept lengths equal",
                         "bf16_tie_ulps": SERVING_TIE_ULPS,
                         "kernel": {"out": ATTN_TOL, "m_l": STAT_RTOL},
                         "capture": "bit-identical"},
          **results})


#: the near-tie study (``--serving-gaps``): target seeds, prompts a seed
#: (random token ids, lengths drawn from ``SERVING_PROMPT_LEN``), and the
#: verify blocks it runs beside greedy decoding: sound, and with a fault
#: planted (RoPE positions one ahead; a rollback that keeps one rejected
#: slot a step)
SERVING_GAP_SEEDS, SERVING_GAP_PROMPTS = 4, 3
SERVING_GAP_VARIANTS = ("sound", "wrong_position", "stale_slot")


def random_target_params(config: dict, device, seed: int, std: float,
                         root: Path) -> tuple:
    """``write_capture_target``'s kind of weights (bf16 drawn from the seed
    at ``std``, norms 1, biases 0), kept on ``device`` and written nowhere
    but ``root``'s config.json → (params, TargetConfig)."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(config))
    tc = TargetConfig.from_file(str(root))
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    fill = {"norm1": 1.0, "norm0": 0.0, "bias": 0.0}
    params = {}
    for name, (shape, kind) in tensor_shapes(tc, config).items():
        if kind in ("weight", "embed"):
            params[name] = (torch.randn(shape, generator=gen, device=device)
                            * std).to(torch.bfloat16)
        else:
            params[name] = torch.full(shape, fill[kind], dtype=torch.bfloat16,
                                      device=device)
    return params, tc


def verify_logits(params, config, prompt, tokens, k: int, max_len: int,
                  variant: str, gen) -> torch.Tensor:
    """Greedy decoding's ``tokens`` fed back one a step as the first token
    of a (k+1)-token verify block (k random proposals after it), one slot
    kept a step, as a chain round that accepts no proposal keeps it; the
    prompt's prefill as greedy's. ``variant`` plants a fault: RoPE
    positions one ahead (``wrong_position``), or two slots kept a step, so
    a rejected proposal's K/V stays in the cache (``stale_slot``) → the
    block's first row of logits a step [len(tokens) - 1, V], each
    predicting greedy's next token."""
    device = params["model.embed_tokens.weight"].device
    vocab = params["model.embed_tokens.weight"].shape[0]
    state = spec_decode.init_target_state(config, 1, max_len, device=device)
    ck, cv = state.cache_k, state.cache_v
    spec_decode.target_cached_forward(
        params, config, torch.tensor([prompt], device=device), ck, cv, 0, ())
    depths = torch.arange(k + 1, device=device) + (
        variant == "wrong_position")
    rows, length = [], len(prompt)
    for tok in tokens[:-1]:
        block = torch.cat([torch.tensor([int(tok)], device=device),
                           torch.randint(0, vocab, (k,), generator=gen,
                                         device=device)])
        logits, _, _, _ = spec_decode.target_cached_forward(
            params, config, block[None], ck, cv, length, (),
            block_positions=depths)
        rows.append(logits[0, 0])
        length += 2 if variant == "stale_slot" else 1
    return torch.stack(rows)


def margin_shifts(greedy_rows: torch.Tensor, rows: torch.Tensor) -> dict:
    """Row by row against greedy's rows: how far the margin of greedy's
    token over the best other token moved, in bf16 ulps of greedy's top-1
    logit; where the argmax left greedy's token (with greedy's top-2 gap
    there); and the ``excess_ulps`` of each row's argmax under greedy's
    row, what ``departures`` holds a decoder's tokens to."""
    g, v = greedy_rows.float(), rows.float()
    best = g.argmax(dim=-1, keepdim=True)
    ulps = torch.tensor([bf16_ulp(x) for x in g.gather(1, best)[:, 0]
                         .tolist()], device=g.device)

    def margin(x):
        top = x.gather(1, best)[:, 0]
        return top - x.scatter(1, best, -math.inf).amax(dim=-1)

    shift = ((margin(v) - margin(g)).abs() / ulps).tolist()
    gaps = (margin(g) / ulps).tolist()
    flips = (v.argmax(dim=-1) != best[:, 0]).nonzero()[:, 0].tolist()
    return {"shift_ulps": shift, "flip_gaps_ulps": [gaps[i] for i in flips],
            "first_flip": flips[0] if flips else None,
            "excess_ulps": excess_ulps(g, v.argmax(dim=-1))}


def serving_gaps_phase(seed: int, config: dict = QWEN3_8B_TARGET, *,
                       device=None, seeds: int = SERVING_GAP_SEEDS,
                       prompts: int = SERVING_GAP_PROMPTS,
                       prompt_len=SERVING_PROMPT_LEN,
                       new_tokens: int = SERVING_NEW_TOKENS,
                       k: int = SERVING_K, max_len: int = SERVING_MAX_LEN,
                       draft_config: Path = CONFIG) -> dict:
    """The spread behind ``SERVING_TIE_ULPS``, in bf16 at ``config``'s
    width and depth (all 36 layers of Qwen3-8B by default), over ``seeds``
    random targets of ``prompts`` random prompts each: greedy decoding's
    logits against the (k+1)-token verify block's at the same positions
    (``verify_logits``, sound and with each planted fault: the margin
    shifts, the argmax flips and greedy's gap at each, the argmax's excess
    under greedy's row), and the chain decoder (a random draft) and the
    plain decoder held to greedy along their own output (``departures``).
    ``check_serving_gaps`` raises, after the line, if a sound path goes
    past the bound."""
    device = device or torch.device("cuda")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    draft_cfg = Eagle3Config.from_file(draft_config)
    rng = np.random.default_rng(seed + 1919)
    gen = torch.Generator(device=device).manual_seed(seed + 19)
    t_start = time.perf_counter()
    variants = {v: {"shift_ulps": [], "flip_gaps_ulps": [],
                    "first_flip_gaps_ulps": [], "excess_ulps": [],
                    "prompts_past_bound": 0} for v in SERVING_GAP_VARIANTS}
    decoders = {name: {"first_difference": [], "excess_ulps": [],
                       "max_excess_ulps": []}
                for name in ("generate_fused", "fused_plain_decode")}
    n = config["num_hidden_layers"]
    with tempfile.TemporaryDirectory() as tmp:
        for s in range(seeds):
            params, tc = random_target_params(config, device, seed + s,
                                              TARGET_STD, Path(tmp) / str(s))
            draft = LlamaEagle3Draft(draft_cfg, dtype=torch.bfloat16,
                                     device=device, seed=seed + s)
            decoder = spec_decode.Eagle3SpecDecoder(
                params, tc, draft.to(torch.bfloat16),
                capture_layers=(1, n // 2 - 1, n - 4), num_draft_tokens=k,
                max_len=max_len, device=device)
            for _ in range(prompts):
                prompt = rng.integers(0, tc.vocab_size, size=int(
                    rng.integers(prompt_len[0], prompt_len[1] + 1))).tolist()
                tokens, g_rows = greedy_logits(params, tc, prompt, new_tokens,
                                               max_len)
                new = tokens[len(prompt):]
                for variant, acc in variants.items():
                    rows = verify_logits(params, tc, prompt, new, k, max_len,
                                         variant, gen)
                    got = margin_shifts(g_rows[1:], rows)
                    acc["shift_ulps"] += got["shift_ulps"]
                    acc["flip_gaps_ulps"] += got["flip_gaps_ulps"]
                    acc["excess_ulps"] += got["excess_ulps"]
                    acc["prompts_past_bound"] += (
                        max(got["excess_ulps"]) > SERVING_TIE_ULPS)
                    if got["first_flip"] is not None:
                        acc["first_flip_gaps_ulps"].append(
                            got["flip_gaps_ulps"][0])
                spec = decoder.generate_fused(prompt, new_tokens).output_ids
                plain = spec_decode.fused_plain_decode(
                    params, tc, prompt, new_tokens, max_len=max_len,
                    loop_cache=decoder.plain_loops)
                for name, got in (("generate_fused", spec),
                                  ("fused_plain_decode", plain)):
                    at, excess = departures(params, tc, prompt, got,
                                            new_tokens, max_len)
                    acc = decoders[name]
                    acc["first_difference"].append(at)
                    acc["excess_ulps"].append(
                        None if at is None else excess[at])
                    acc["max_excess_ulps"].append(max(excess))
            del decoder, draft, params
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
    sync()
    def spread(values) -> dict:
        values = np.asarray(values)
        return {"median": float(np.median(values)),
                "p99": float(np.quantile(values, 0.99)),
                "max": float(values.max())}

    summary = {}
    for variant, acc in variants.items():
        excess = np.asarray(acc["excess_ulps"])
        summary[variant] = {
            "positions": int(excess.size),
            "shift_ulps": spread(acc["shift_ulps"]),
            "flips": len(acc["flip_gaps_ulps"]),
            "flip_gaps_ulps": spread(acc["flip_gaps_ulps"] or [0.0]),
            "first_flip_gaps_ulps": acc["first_flip_gaps_ulps"],
            "excess_ulps": spread(excess),
            "positions_past_bound": int((excess > SERVING_TIE_ULPS).sum()),
            "prompts_past_bound": acc["prompts_past_bound"]}
    results = {"seeds": seeds, "prompts_per_seed": prompts,
               "new_tokens": new_tokens, "num_draft_tokens": k,
               "max_len": max_len, "layers": n, "verify": summary,
               "decoders": decoders,
               "tie_ulps": SERVING_TIE_ULPS,
               "seconds": time.perf_counter() - t_start}
    return results


def check_serving_gaps(results: dict) -> None:
    """The sound verify block and both decoders within the bound."""
    worst = {name: max(acc["max_excess_ulps"])
             for name, acc in results["decoders"].items()}
    worst["sound verify"] = results["verify"]["sound"]["excess_ulps"]["max"]
    over = {name: w for name, w in worst.items() if w > SERVING_TIE_ULPS}
    if over:
        raise AssertionError(f"bf16 tokens {over} ulps below greedy's top-1 "
                             f"(more than {SERVING_TIE_ULPS}: not near-ties)")


def capture_and_train_phase(seed: int, depth: int,
                            keep: Optional[Path] = None) -> tuple:
    """Slice 16 on the card: ``capture_phase`` at Qwen3-8B width and
    ``depth`` layers, then the training phase on its features (with the
    exports), slice 19's serving phase on that target and the SGLang
    export, the block serving phase (its dflash-layout capture, the
    Domino, DSpark and DFlash family phases on it, each with its line),
    then the online phase from the same target, a line each →
    (training results, launch counts, the family phases' results and
    launch counts by kind, the block decoders' DFlash forward launches). ``keep``: the target and the
    capture's one-process reference (``dense_target``, ``dense_ref.pt``)
    are kept there for the capture-mesh phase."""
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        results, captured = capture_phase(
            CONFIG, device, seed, Path(tmp), depth=depth,
            ref_path=None if keep is None else keep / "dense_ref.pt")
        full = QWEN3_8B_TARGET["num_hidden_layers"]
        emit({"phase": "capture", "draft_config": str(CONFIG.relative_to(
                  REPO)),
              "layout": "eagle", "template": "qwen",
              "reduced": {
                  "weights": f"random, from --seed (std {TARGET_STD})",
                  "depth": None if depth == full else
                  f"{depth} of {full} layers (the default run's 1,200 s; "
                  "--capture-only runs all 36), capture layers by the "
                  "same rule",
                  "samples": f"{TRAIN_FILES} train and {EVAL_FILES} eval "
                             "conversations of 1536-2048 tokens"},
              "tolerances": {"rel_l2": CAPTURE_REL_L2},
              **results})
        torch.cuda.empty_cache()
        training, counts = run_training(CONFIG, device, seed, Path(tmp),
                                        captured)
        check_training_counts(counts, training["micro_batches"],
                              training["eval_forwards"])
        emit({"phase": "training", "config": str(EXAMPLE.relative_to(REPO)),
              "draft_config": str(CONFIG.relative_to(REPO)), "batch": BATCH,
              "max_length": MAX_LEN, "ttt_length": TTT,
              "accumulation_steps": ACCUM, "launches": counts,
              "features": "captured (phase capture)",
              "tolerances": {"step1_loss_rtol": TRAIN_STEP1_RTOL,
                             "later_loss_rtol": TRAIN_DRIFT_RTOL,
                             "grad_cosine": GRAD_COSINE,
                             "grad_norm_rtol": GRAD_NORM_RTOL},
              **training})
        torch.cuda.empty_cache()
        serving = serving_phase(captured, Path(tmp) / "export" / "sglang",
                                Path(tmp), seed, device)
        emit_serving(serving, depth)
        torch.cuda.empty_cache()
        block, families = dflash_serving_phase(
            captured, Path(tmp), seed, device, depth,
            on_training=functools.partial(emit_block_family, Path(tmp)))
        emit_dflash_serving(block, depth)
        torch.cuda.empty_cache()
        online = online_phase(CONFIG, captured, Path(tmp) / "online", seed,
                              device)
        emit_online(online, depth)
        if keep is not None:
            shutil.move(str(captured["target"]), str(keep / "dense_target"))
    training["online_launches"] = online["launches"]
    torch.cuda.empty_cache()
    return training, counts, families, block["serving_launches"]


def emit_online(results: dict, depth: int) -> None:
    full = QWEN3_8B_TARGET["num_hidden_layers"]
    emit({"phase": "online", "config": str(ONLINE_EXAMPLE.relative_to(REPO)),
          "draft_config": str(CONFIG.relative_to(REPO)),
          "command": "python -m specforge_tpu_torch.cli train -c "
                     f"{ONLINE_EXAMPLE.relative_to(REPO)} --set ... "
                     "--managed-local",
          "accumulation_steps": ONLINE_ACCUM,
          "ttt_length": TTT, "max_length": MAX_LEN,
          "reduced": {
              "weights": f"random, from --seed (std {TARGET_STD})",
              "depth": None if depth == full else
              f"{depth} of {full} target layers (the capture phase's "
              "target; --online-only runs all 36)",
              "overrides": "model.target_model_path, draft_config_path and "
                           "vocab_mapping_path, data.prompt_path, "
                           "output_dir, runtime.store_endpoint and "
                           "control_dir, deployment.server_urls (free "
                           "ports, the run's directory); "
                           f"training.accumulation_steps {ONLINE_ACCUM}, "
                           f"not 8; total_steps {ONLINE_STEPS}, not 5000; "
                           f"save_interval {ONLINE_STEPS}, not 1000; "
                           "log_interval 1, not 50",
              "prompts": f"{len(results['prompt_lengths'])} tokenised "
                         "prompts of 1536-2048 tokens from --seed",
              "ranks": "one capture server rank and one consumer"
                       if results["ranks"] == 1 else
                       f"{results['ranks']} capture server ranks and "
                       f"{results['ranks']} consumer ranks, a card each"},
          "tolerances": {"step1_loss_rtol": TRAIN_STEP1_RTOL,
                         "features": "bit-identical"},
          **results})


def online_only_phase(seed: int) -> None:
    """``--online-only``: the online phase alone, from a random target of
    all 36 Qwen3-8B layers written here, the vocab mapping derived from
    the prompts; on a machine of several cards the capture server and the
    consumer take a rank per card (NCCL)."""
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        target = write_capture_target(Path(tmp) / "target", QWEN3_8B_TARGET,
                                      device, seed, TARGET_STD)
        written = time.perf_counter() - t0
        torch.cuda.empty_cache()
        results = online_phase(CONFIG, {"target": target,
                                        "vocab_mapping": None},
                               Path(tmp) / "online", seed, device,
                               ranks=torch.cuda.device_count())
    results["target_write_s"] = written
    emit_online(results, QWEN3_8B_TARGET["num_hidden_layers"])


# --------------------------------------------------------------------------
# slice 18: the online disaggregated runtime
# --------------------------------------------------------------------------

ONLINE_EXAMPLE = REPO / "examples" / "qwen3-8b-eagle3-online.json"
#: tokenised prompts the producer captures: 2 optimizer steps of 2
#: micro-batches of 2
ONLINE_PROMPTS = 8
ONLINE_BATCH, ONLINE_ACCUM, ONLINE_STEPS = 2, 2, 2
#: seconds the managed stack may take (the target's load included)
ONLINE_TIMEOUT = 600
#: seconds the capture server may take to answer /health
ONLINE_READY_TIMEOUT = 300


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def json_blocks(text: str) -> list:
    """The JSON objects a process printed, on one line or over several:
    each ``{`` that starts a whole object, scanned left to right, so the
    output of processes sharing a file parses where one's object lands
    right after another's, without the newline between."""
    decoder, out, i = json.JSONDecoder(), [], 0
    while (i := text.find("{", i)) >= 0:
        try:
            obj, i = decoder.raw_decode(text, i)
        except ValueError:
            i += 1
            continue
        if isinstance(obj, dict):
            out.append(obj)
    return out


def http_json(url: str, body=None, timeout: float = 300.0) -> dict:
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def inline_tensors(spec: dict) -> dict:
    """The tensors of an ``inline`` sink's ``spec_capture``."""
    import base64

    return {name: torch.frombuffer(
                bytearray(base64.b64decode(spec["data"][name])),
                dtype=getattr(torch, meta["dtype"])).reshape(meta["shape"])
            for name, meta in spec["features"].items()}


class StackWatch:
    """A thread beside the managed stack: polls the capture server's
    /health (the time to ready, the last answer), and once it answers asks
    for every prompt batch of the producer's first lease with the
    ``inline`` sink, so the features come back to this process."""

    def __init__(self, url: str, batches: list, t0: float):
        self.url, self.batches, self.t0 = url, batches, t0
        self.ready_s = None
        self.health = None
        self.inline = []
        self.error = None
        self.done = False
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._stop:
                try:
                    self.health = http_json(f"{self.url}/health", timeout=2)
                except OSError:
                    if self.ready_s is not None and self.done:
                        return  # the stack is going down
                    time.sleep(0.25)
                    continue
                if self.ready_s is None:
                    self.ready_s = time.perf_counter() - self.t0
                    for batch in self.batches:
                        body = {"samples": [
                            {"input_ids": t.payload["input_ids"],
                             "loss_mask": t.payload["loss_mask"],
                             "sample_id": t.prompt_id} for t in batch],
                            "spec_capture": {"sink": "inline"}}
                        results = http_json(f"{self.url}/generate_batch",
                                            body)["results"]
                        self.inline.append([
                            inline_tensors(r["meta_info"]["spec_capture"])
                            for r in results])
                    self.done = True
                time.sleep(0.5)
        except BaseException as exc:  # noqa: BLE001 — read by the phase
            self.error = exc

    def stop(self):
        self._stop = True
        self._thread.join(timeout=30)


def online_prompt_records(vocab_size: int, seed: int, n: int, min_len: int,
                          max_length: int) -> list:
    """``n`` tokenised prompts of ``min_len``-``max_length`` tokens, made
    from the seed as the capture phase makes its conversations."""
    tokenizer = SpreadTokenizer(vocab_size)
    parsed = build_dataset(synthetic_conversations(
        n, tokenizer, seed + 18, min_len, max_length), tokenizer, "qwen",
        max_length)
    if len(parsed) != n:
        raise AssertionError(f"{len(parsed)} supervised prompts of {n}")
    return [{"input_ids": [int(t) for t in p.input_ids],
             "loss_mask": [int(m) for m in p.loss_mask]} for p in parsed]


def metric_steps(path: Path) -> list:
    return [r for r in (json.loads(line) for line in
                        path.read_text().splitlines())
            if "train/loss" in r]


def online_phase(cfg_path: Path, captured: dict, workdir: Path, seed: int,
                 device, *, n_prompts=ONLINE_PROMPTS, min_len=1536,
                 max_length=MAX_LEN, timeout=ONLINE_TIMEOUT,
                 ranks: int = 1) -> dict:
    """Slice 18 on the card: ``python -m specforge_tpu_torch.cli train -c
    <run file> --managed-local`` (role ``auto``) on
    ``examples/qwen3-8b-eagle3-online.json`` with its paths, ports and
    steps overridden, so the port's launch plan starts the store server it
    built, a capture server holding ``captured["target"]``, the producer
    and the consumer, which trains ``cfg_path`` on the TTT and fused CE
    kernels. Beside the stack, this process asks the capture server for
    the producer's prompt batches with the ``inline`` sink. Checks: the
    supervisor (so every worker) exits 0 and the server ran on the
    device; every kernel of the consumer's path launched TTT times a
    micro-step (read from its jsonl tracker, on the card); the store holds
    0 objects after the acks and the ledger's durable step is the last
    step; the first batch's inline features bit-identical to the port's
    ``OfflineCaptureRunner._run_batch`` run here on the same padded shape;
    the online step-1 loss within ``TRAIN_STEP1_RTOL`` of an offline ``cli
    train`` run over the same features in the inbox's order, from the same
    draft initialisation. ``captured["vocab_mapping"]`` None: derived from
    the prompts' ids here. ``ranks`` > 1: the capture server shards the
    target over that many ranks (``capture_shard_devices``) and the
    consumer runs as that many ranks (``training.fsdp_size``: the launch
    plan starts a consumer a rank of its mesh; a global batch of at least
    one row a rank), the offline run in one process taking each
    micro-batch's rows in rank order."""
    from specforge_tpu_torch.data.prompt_builder import prepare_prompt_tasks
    from specforge_tpu_torch.inference.batch_partition import (
        TargetBatchPartition,
    )
    from specforge_tpu_torch.inference.capture_server import (
        CaptureEngine,
        resolve_batch_shape,
    )
    from specforge_tpu_torch.runtime.data_plane.network_store import (
        server_binary,
    )
    from specforge_tpu_torch.training.vocab_mapping import (
        derive_vocab_mapping,
    )

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    workdir.mkdir(parents=True, exist_ok=True)
    target = Path(captured["target"])
    tc = TargetConfig.from_file(str(target))
    batch_size = max(ONLINE_BATCH, ranks)
    n_prompts = max(n_prompts, batch_size * ONLINE_ACCUM * ONLINE_STEPS)
    records = online_prompt_records(tc.vocab_size, seed, n_prompts, min_len,
                                    max_length)
    prompts = workdir / "prompts.jsonl"
    prompts.write_text("".join(json.dumps(r) + "\n" for r in records))
    mapping = captured.get("vocab_mapping")
    draft = json.loads(cfg_path.read_text())
    if mapping is None:
        mapping = workdir / "vocab_mapping.npz"
        save_vocab_mapping(str(mapping), *derive_vocab_mapping(
            (np.asarray(r["input_ids"]) for r in records), tc.vocab_size,
            draft["draft_vocab_size"]))

    store_port, server_port = free_port(), free_port()
    server_url = f"http://127.0.0.1:{server_port}"
    out = workdir / "runs"
    overrides = [
        f'model.target_model_path="{target}"',
        f'model.draft_config_path="{cfg_path}"',
        f'model.vocab_mapping_path="{mapping}"',
        f'data.prompt_path="{prompts}"', f"data.max_length={max_length}",
        f'output_dir="{out}"',
        f'runtime.store_endpoint="127.0.0.1:{store_port}"',
        f'runtime.control_dir="{workdir / "control"}"',
        f'deployment.server_urls=["{server_url}"]',
        f"training.batch_size={batch_size}",
        f"training.accumulation_steps={ONLINE_ACCUM}",
        f"training.total_steps={ONLINE_STEPS}",
        f"training.save_interval={ONLINE_STEPS}", "training.log_interval=1",
    ]
    if ranks > 1:  # the consumer's mesh, a rank each: fsdp over them
        overrides += [
            f"deployment.managed_local.capture_shard_devices={ranks}",
            f"training.fsdp_size={ranks}"]
    config = load_config(str(ONLINE_EXAMPLE), overrides)
    device_args = [] if on_card else ["--device", str(device)]
    # the producer's first lease and its batches, as its worker makes them
    tasks = prepare_prompt_tasks(records, epoch=0,
                                 prompt_seed=config.training.seed)
    lease = config.runtime.capture_batch_size
    batches = TargetBatchPartition(
        max_batch_tokens=config.runtime.capture_batch_tokens,
        max_batch_size=lease).partition(tasks[:lease])

    t0 = time.perf_counter()
    server_binary()  # built by the build phase: the supervisor reuses it
    results = {"store_server_build_s": time.perf_counter() - t0}
    argv = [sys.executable, "-m", "specforge_tpu_torch.cli", "train", "-c",
            str(ONLINE_EXAMPLE), *[a for o in overrides for a in ("--set", o)],
            "--managed-local", *device_args]
    stdout_path, stderr_path = workdir / "stack.out", workdir / "stack.err"
    t0 = time.perf_counter()
    with open(stdout_path, "w") as so, open(stderr_path, "w") as se:
        proc = subprocess.Popen(argv, cwd=REPO, stdout=so, stderr=se,
                                start_new_session=True)
        watch = StackWatch(server_url, batches, t0)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            raise AssertionError(f"the managed stack ran past {timeout} s")
        finally:
            watch.stop()
            # the stack's processes are the supervisor's session
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, 9)
    results["stack_s"] = time.perf_counter() - t0
    stdout, stderr = stdout_path.read_text(), stderr_path.read_text()
    if rc != 0:
        raise AssertionError(f"the managed stack exited {rc}:\n"
                             f"{stdout[-3000:]}\n{stderr[-6000:]}")
    if watch.error is not None or not watch.done:
        raise AssertionError(f"the inline capture failed: {watch.error!r}")
    health = watch.health
    if not health["device"].startswith(device.type):
        raise AssertionError(f"the capture server ran on {health['device']}")
    printed = json_blocks(stdout)
    producer = next(b for b in printed if "samples_produced" in b)
    consumer = next(b for b in printed if "store/objects" in b)
    if producer["samples_produced"] != n_prompts:
        raise AssertionError(f"{producer['samples_produced']} samples "
                             f"produced of {n_prompts}")
    if consumer["store/objects"] != 0:
        raise AssertionError(f"{consumer['store/objects']} objects left in "
                             "the store after the acks")
    state = out / config.run_id / "consumer_state"
    import sqlite3

    with contextlib.closing(sqlite3.connect(state / "consumer.sqlite")) as db:
        durable = db.execute("SELECT value FROM markers WHERE name = "
                             "'global_step'").fetchone()[0]
        acked = db.execute("SELECT COUNT(*) FROM acked").fetchone()[0]
    if durable != ONLINE_STEPS or acked != n_prompts:
        raise AssertionError(f"the ledger's durable step {durable} and "
                             f"{acked} acked samples, expected "
                             f"{ONLINE_STEPS} and {n_prompts}")
    steps = metric_steps(out / f"{config.run_id}.metrics.jsonl")
    if [r["step"] for r in steps] != list(range(1, ONLINE_STEPS + 1)):
        raise AssertionError(f"online steps {[r['step'] for r in steps]}")
    micro = ONLINE_STEPS * ONLINE_ACCUM
    launches = {name: int(sum(r.get(f"perf/launches/{fn.__name__}", 0)
                              for r in steps))
                for name, fn in KERNEL_COUNTERS.items()}
    expected = TTT * micro if on_card else 0
    for name, n in launches.items():
        if n != expected:
            raise AssertionError(
                f"{name}: {n} launches in the online consumer, expected "
                f"{expected} ({TTT} per micro-batch)")

    # the first batch's features against the runner in this process, on
    # the same padded shape
    providers = builtin_algorithm_registry().resolve("eagle3").providers
    layers = tuple(providers.resolve_capture_layers(
        providers.draft_config(draft), tc.num_hidden_layers, None))
    t0 = time.perf_counter()
    runner = OfflineCaptureRunner(
        OfflineCaptureConfig(str(target), str(workdir / "unused"), layers,
                             max_length, 1),
        device=None if on_card else device)
    first = batches[0]
    lengths = [min(len(t.payload["input_ids"]), max_length) for t in first]
    bsz, seq = resolve_batch_shape(len(first), max(lengths), max_length,
                                   CaptureEngine.SEQ_BUCKETS,
                                   CaptureEngine.BATCH_BUCKETS)
    ids = np.zeros((bsz, seq), np.int64)
    mask = np.zeros((bsz, seq), np.int64)
    for i, (task, n) in enumerate(zip(first, lengths)):
        ids[i, :n] = task.payload["input_ids"][:n]
        mask[i, :n] = 1
    aux, last = runner._run_batch(ids, mask)
    del runner
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    differing = []
    for i, (got, n) in enumerate(zip(watch.inline[0], lengths)):
        for name, ref in (("hidden_state", aux[i, :n]),
                          ("target", last[i, :n])):
            if not torch.equal(got[name], ref.to(torch.bfloat16)):
                differing.append((i, name, max_err(got[name], ref)))
    if differing:
        raise AssertionError(f"the server's features differ from the "
                             f"runner's at the same shape: {differing}")
    results["features"] = {"batch": [bsz, seq], "samples": len(first),
                           "bit_identical": True,
                           "runner_s": time.perf_counter() - t0}

    # offline: the same features in the inboxes' order, one window: each
    # micro-batch the ranks' rows in rank order
    inboxes = [[json.loads(line)["sample_id"] for line in
                (state / "inboxes-g0" / f"rank{r}.jsonl").read_text()
                .splitlines() if json.loads(line).get("kind") == "ref"]
               for r in range(ranks)]
    rows = batch_size // ranks
    order = [sid for j in range(ONLINE_ACCUM) for inbox in inboxes
             for sid in inbox[j * rows:(j + 1) * rows]]
    captured_by_id = {t.prompt_id: tensors
                      for batch, got in zip(batches, watch.inline)
                      for t, tensors in zip(batch, got)}
    features = workdir / "offline_features"
    features.mkdir()
    for i, sid in enumerate(order[:batch_size * ONLINE_ACCUM]):
        save_feature_file(str(features / f"{i:04d}.sft"),
                          captured_by_id[sid], {"target_repr": "hidden_state"})
    off_out = workdir / "offline_runs"
    t0 = time.perf_counter()
    cli.main(["train", "-c", str(ONLINE_EXAMPLE),
              *[a for o in overrides if not o.startswith((
                  "deployment.managed_local", "training.fsdp_size"))
                for a in ("--set", o)],
              "--set", 'training.role="all"',
              "--set", f'data.train_data_path="{features}"',
              "--set", f'output_dir="{off_out}"', *device_args])
    results["offline_run_s"] = time.perf_counter() - t0
    offline = metric_steps(off_out / f"{config.run_id}.metrics.jsonl")
    online_loss, offline_loss = steps[0]["train/loss"], offline[0][
        "train/loss"]
    rel = abs(online_loss - offline_loss) / abs(offline_loss)
    if not rel <= TRAIN_STEP1_RTOL:
        raise AssertionError(f"online step-1 loss {online_loss} against "
                             f"offline {offline_loss}: {rel}")

    results.update({
        "ranks": ranks, "batch": batch_size,
        # each capture rank's line at its stop (its peak memory)
        "server_ranks": [b for b in printed if "capture_rank" in b],
        "supervisor_rc": rc,
        "server": {k: health.get(k) for k in (
            "device", "device_name", "max_memory_allocated", "coalesce")},
        "server_ready_s": watch.ready_s,
        "producer": producer,
        "consumer": {
            "step_s": [3600.0 / r["perf/steps_per_hour"] for r in steps],
            "compute_s": [r["perf/compute_s_per_step"] for r in steps],
            "data_wait_s": [r["perf/data_wait_s_per_step"] for r in steps],
            "ack_s": [r["perf/ack_s_per_step"] for r in steps],
            "loss": [r["train/loss"] for r in steps],
            "max_memory_allocated": steps[-1].get(
                "perf/max_memory_allocated"),
        },
        "store": {k.split("/", 1)[1]: v for k, v in consumer.items()
                  if k.startswith("store/")},
        "ledger": {"durable_step": durable, "acked": acked},
        "launches": launches,
        "step1_loss": {"online": online_loss, "offline": offline_loss,
                       "rel_diff": rel},
        "capture_layers": list(layers),
        "prompt_lengths": [len(r["input_ids"]) for r in records],
        "prompt_batches": [len(b) for b in batches],
        "online_s": time.perf_counter() - t_phase,
    })
    return results


# --------------------------------------------------------------------------
# slice 3: DFlash-family offline training at Qwen3-8B width
# --------------------------------------------------------------------------

DOMINO_CONFIG = REPO / "configs" / "qwen3-8b-domino.json"
DOMINO_EXAMPLE = REPO / "examples" / "qwen3-8b-domino-offline.json"
DFLASH_CONFIG = REPO / "configs" / "qwen3-8b-dflash.json"
DSPARK_CONFIG = REPO / "configs" / "qwen3-8b-dspark.json"
DSPARK7_CONFIG = REPO / "configs" / "qwen3-4b-dspark.json"
#: the drafts the block serving phase trains (``BLOCK_FAMILIES``) and serves
BLOCK_CONFIG_FILES = {"domino": DOMINO_CONFIG, "dspark": DSPARK_CONFIG,
                      "dflash": DFLASH_CONFIG}
#: the Domino and DSpark runs: 16 files of 512-768 tokens, 4 optimizer
#: steps of 2 micro-batches; the DFlash step and the DSpark step at blocks
#: of 7: 4 files, one optimizer step
FAMILY_FILES = {"domino": 16, "dflash": 4, "dspark": 16, "dspark_block7": 4}
#: the run through cli train (the others run one window of the trainer)
FAMILY_CLI = ("domino", "dspark")
#: DSpark's ratio metrics, each logged as train/<name>
DSPARK_METRICS = ("acc", "ce_loss", "l1_loss", "confidence_loss",
                  "confidence_abs_error", "teacher_agreement",
                  "teacher_top1_prob", "draft_top1_prob",
                  "tau_probabilistic")
DFLASH_COUNTERS = {
    "dflash_attention_fwd": dflash_attention_cuda.dflash_flash_attention_fwd,
    "dflash_attention_bwd_dq": dflash_attention_cuda.dflash_attention_bwd_dq,
    "dflash_attention_bwd_dkv": dflash_attention_cuda.dflash_attention_bwd_dkv,
}


def write_dflash_features(root: Path, n_capture: int, hidden: int,
                          vocab: int, seed: int, n_files: int, min_len: int,
                          max_len: int, last_hidden: bool = False) -> None:
    """Offline DFlash feature files (``input_ids``, ``loss_mask`` over the
    response part, ``hidden_states`` [S, n_capture·hidden] bf16 and, for
    DSpark, ``target_last_hidden_states`` [S, hidden] bf16), written by the
    port's writer from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        n = int(torch.randint(min_len, max_len + 1, (1,), generator=gen))
        prompt = int(torch.randint(n // 10, n // 3, (1,), generator=gen))
        loss_mask = torch.zeros(n, dtype=torch.int64)
        loss_mask[prompt:] = 1
        tensors = {
            "input_ids": torch.randint(0, vocab, (n,), generator=gen),
            "loss_mask": loss_mask,
            "hidden_states": torch.randn(n, n_capture * hidden,
                                         generator=gen).to(torch.bfloat16),
        }
        if last_hidden:
            tensors["target_last_hidden_states"] = torch.randn(
                n, hidden, generator=gen).to(torch.bfloat16)
        save_feature_file(str(root / f"sample-{i:04d}.sft"), tensors,
                          {"target_repr": "hidden_state"})


def family_run_json(kind: str, workdir: Path, draft_config: Path,
                    target: Path, max_length: int,
                    train_dir: Optional[Path] = None) -> Path:
    """``examples/qwen3-8b-domino-offline.json``, read as data, pointed at
    this run's directories (the features in ``train_dir``, else
    ``workdir / "train"``), with accumulation 2 (from 8) and a log line per
    step; for ``dflash`` the same run with the dflash strategy and its
    default 512 anchors, for ``dspark`` and ``dspark_block7`` with the
    dspark strategy (the example's 256 anchors). The checkpoint is written
    at the epoch's end."""
    raw = json.loads(DOMINO_EXAMPLE.read_text())
    raw["run_id"] = kind
    raw["output_dir"] = str(workdir / "runs")
    raw["model"].update(target_model_path=str(target),
                        draft_config_path=str(draft_config))
    raw["data"].update(train_data_path=str(train_dir or workdir / "train"),
                       max_length=max_length, num_workers=2)
    raw["training"].update(accumulation_steps=ACCUM, log_interval=1)
    if kind == "dflash":
        raw["training"].update(strategy="dflash", num_anchors=512)
    elif kind.startswith("dspark"):
        raw["training"].update(strategy="dspark")
    raw["tracking"] = {"backend": "jsonl"}
    path = workdir / "run.json"
    path.write_text(json.dumps(raw, indent=2))
    return path


def train_windows(trainer) -> list:
    """The trainer's own train step over every accumulation window of its
    loader (no checkpoint) → per-step metrics as floats."""
    steps = []
    for stacked, _ids, _meta in trainer._accum_groups(trainer.train_loader):
        trainer.state, metrics = trainer.train_step(trainer.state, stacked,
                                                    trainer.frozen)
        steps.append({"step": trainer.state.step,
                      **{k: float(v) for k, v in metrics.items()}})
    return steps


def compare_curves(kernel: list, plain: list) -> list:
    curve = []
    for k, p in zip(kernel, plain, strict=True):
        if not (math.isfinite(k["train/loss"])
                and math.isfinite(p["train/loss"])):
            raise AssertionError(f"step {k['step']}: loss not finite")
        rel = abs(k["train/loss"] - p["train/loss"]) / abs(p["train/loss"])
        check(f"step {k['step']} train/loss, kernel vs plain", rel,
              TRAIN_STEP1_RTOL if k["step"] == 1 else TRAIN_DRIFT_RTOL)
        curve.append({"step": k["step"], "loss": k["train/loss"],
                      "plain_loss": p["train/loss"], "rel_diff": rel,
                      "grad_norm": k["train/grad_norm"],
                      "plain_grad_norm": p["train/grad_norm"]})
    return curve


def run_family_training(kind: str, cfg_path: Path, device, seed: int,
                        workdir: Path, *, max_length=768, min_len=512,
                        head_std=0.02, overrides=(),
                        features: Optional[Path] = None,
                        target: Optional[Path] = None,
                        export_to: Optional[Path] = None) -> tuple:
    """Slice 3 end to end for ``kind`` ("domino", "dflash", "dspark" or
    "dspark_block7"); returns the results and the DFlash kernels' launch
    counts of its main path, set to 0 just before it and read just after.
    ``features`` and ``target``: feature files and a target directory to
    train on (the block serving phase passes its dflash-layout capture and
    its target), else random features and a target holding only a head and
    an embedding, written here; ``export_to``: the ``cli train`` run's
    final checkpoint is exported there by ``cli export --to sglang``.

    domino, dspark: the main path is ``cli.main(["train", ...])`` (4 steps
    and the end-of-epoch checkpoint); then a fresh kernel-path trainer
    gives step 1's loss and gradients and the timings, and a plain-path
    trainer (the draft config's ``attention_backend: "chunked"``, same
    initial weights and anchors) its own, and its loss curve from the
    trainer's train step. dflash, dspark_block7: the main path is the
    kernel-path trainer's train step over its one window (no checkpoint),
    then the same plain-path comparison. DSpark's feature files also hold
    the target's last hidden state, and every step's nine ratio metrics
    must be finite."""
    raw_cfg = json.loads(Path(cfg_path).read_text())
    cfg = DFlashConfig.from_dict(raw_cfg)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    dspark = kind.startswith("dspark")
    workdir.mkdir(parents=True, exist_ok=True)
    if features is None:
        write_dflash_features(workdir / "train",
                              len(cfg.resolved_target_layer_ids),
                              cfg.hidden_size, cfg.vocab_size, seed,
                              FAMILY_FILES[kind], min_len, max_length,
                              last_hidden=dspark)
    if target is None:
        target = write_target_dir(workdir / "target", cfg.vocab_size,
                                  cfg.hidden_size, device, seed, head_std)
    run_json = family_run_json(kind, workdir, cfg_path, target, max_length,
                               features)
    chunked_cfg = workdir / "draft-chunked.json"
    chunked_cfg.write_text(json.dumps({**raw_cfg,
                                       "attention_backend": "chunked"}))
    runs = workdir / "runs"
    overrides = list(overrides)

    def trainer_for(*extra):
        config = load_config(str(run_json), overrides + list(extra))
        return build_training_run(config, device=None if on_card else device)

    results = {"disk_free_bytes": shutil.disk_usage(workdir).free}
    for fn in DFLASH_COUNTERS.values():
        fn.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    if kind in FAMILY_CLI:
        device_args = [] if on_card else ["--device", str(device)]
        rc = cli.main(["train", "-c", str(run_json), *device_args,
                       *[a for o in overrides for a in ("--set", o)]])
        if rc != 0:
            raise AssertionError(f"cli train exited {rc}")
        sync()
        counts = {n: fn.launches for n, fn in DFLASH_COUNTERS.items()}
        kernel_steps = step_records(runs, kind)
        step_dir = Path(CheckpointManager.resolve_step_dir(str(runs)))
        results["checkpoint"] = {
            "dir": step_dir.name,
            "bytes": sum(f.stat().st_size for f in step_dir.rglob("*")
                         if f.is_file()),
        }
        results["main_path_s"] = time.perf_counter() - t0
        if on_card:
            results["main_path_peak_bytes"] = torch.cuda.max_memory_allocated()
        if export_to is not None:
            t0 = time.perf_counter()
            if cli.main(["export", str(runs), "-o", str(export_to), "--to",
                         "sglang", "--draft-config", str(cfg_path),
                         *device_args]) != 0:
                raise AssertionError("cli export exited non-zero")
            results["export"] = {"to": "sglang", "from": step_dir.name,
                                 "s": time.perf_counter() - t0}
        trainer = trainer_for('run_id="kernel"')
        window = first_window(trainer)
        loss_k, grads_k = window_grads(trainer, window)
        grads_k = {k: g.cpu() for k, g in grads_k.items()}
        results.update(measure_kernel_path(trainer, window, sync))
    else:
        trainer = trainer_for()
        window = first_window(trainer)
        loss_k, grads_k = window_grads(trainer, window)
        grads_k = {k: g.cpu() for k, g in grads_k.items()}
        for fn in DFLASH_COUNTERS.values():
            fn.launches = 0
        sync()
        t0 = time.perf_counter()
        kernel_steps = train_windows(trainer)
        sync()
        counts = {n: fn.launches for n, fn in DFLASH_COUNTERS.items()}
        results["main_path_s"] = time.perf_counter() - t0
        if on_card:
            results["main_path_peak_bytes"] = torch.cuda.max_memory_allocated()
    results["micro_batches"] = len(kernel_steps) * ACCUM
    del trainer
    if on_card:
        torch.cuda.empty_cache()

    # the plain path from the same initial weights and anchors: the chunked
    # attention of the draft config's "chunked" backend
    plain = trainer_for(f'model.draft_config_path="{chunked_cfg}"',
                        'run_id="plain"')
    for fn in DFLASH_COUNTERS.values():
        fn.launches = 0
    loss_p, grads_p = window_grads(plain, window)
    check("step-1 loss, kernel vs plain", abs(loss_k - loss_p) / abs(loss_p),
          TRAIN_STEP1_RTOL)
    results["step1"] = {"loss": loss_k, "plain_loss": loss_p}
    results["step1_grads"] = compare_grads(grads_k, grads_p)
    del grads_k, grads_p
    plain_steps = train_windows(plain)
    results["plain_path_launches"] = {n: fn.launches
                                      for n, fn in DFLASH_COUNTERS.items()}
    if any(results["plain_path_launches"].values()):
        raise AssertionError("the chunked plain path launched a DFlash kernel")
    del plain
    if on_card:
        torch.cuda.empty_cache()
    results["loss_curve"] = compare_curves(kernel_steps, plain_steps)
    results["optimizer_steps"] = len(kernel_steps)
    if dspark:
        for r in kernel_steps + plain_steps:
            bad = [m for m in DSPARK_METRICS
                   if not math.isfinite(r[f"train/{m}"])]
            if bad:
                raise AssertionError(f"step {r['step']}: {bad} not finite")
        results["ratio_metrics"] = [
            {m: r[f"train/{m}"] for m in DSPARK_METRICS}
            for r in kernel_steps]
    if kind in FAMILY_CLI:
        b, n = BATCH, load_config(str(run_json), overrides).training.num_anchors
        ms = results["micro_step_ms"]
        results["draft_tokens_per_s"] = b * n * cfg.block_size / (ms / 1e3)
        results["context_tokens_per_s"] = b * max_length / (ms / 1e3)
    if kind == "domino":
        t = load_config(str(run_json), overrides).training
        lambdas = [r["train/lambda_base"] for r in kernel_steps]
        expected = [linear_lambda_base(r["step"] - 1, len(kernel_steps),
                                       t.lambda_base_start,
                                       t.lambda_base_decay_ratio)
                    for r in kernel_steps]
        for step, (got, want) in enumerate(zip(lambdas, expected), 1):
            check(f"step {step} lambda_base", abs(got - want), 1e-6)
        results["lambda_base"] = lambdas
    shutil.rmtree(runs, ignore_errors=True)
    return results, counts


# --------------------------------------------------------------------------
# slice 4: P-EAGLE COD offline training at Qwen3-8B width
# --------------------------------------------------------------------------

PEAGLE_CONFIG = REPO / "configs" / "qwen3-8b-peagle.json"
PEAGLE_EXAMPLE = REPO / "examples" / "qwen3-8b-peagle-single-chip.json"
#: 8 files of 768-1024 tokens: 2 optimizer steps of 2 micro-batches of 2
#: (4 steps before the mesh phase joined the script); the packed step: 16
#: documents of 128-256 tokens, 4 to a row
PEAGLE_FILES, PACK_FILES, DOCS_PER_ROW = 8, 16, 4
PEAGLE_COUNTERS = {
    "cod_attention_fwd": peagle_attention_cuda.cod_attention_fwd,
    "cod_attention_bwd_dq": peagle_attention_cuda.cod_attention_bwd_dq,
    "cod_attention_bwd_dkv": peagle_attention_cuda.cod_attention_bwd_dkv,
    "fused_ce_fwd": loss_cuda.loss_forward,
    "fused_ce_bwd": loss_cuda.loss_backward,
}
#: the row-sparse and the dense embedding update after one step: the
#: difference of the touched rows over their largest value, as
#: tests/test_sparse_embed.py holds the two paths (fp32 sums of the same
#: gradient terms in other orders; the difference over the largest update
#: is reported beside it)
EMBED_UPDATE_RTOL = 1e-5
EMBED_PATH = "draft_model.embed_tokens.weight"


def peagle_run_json(workdir: Path, draft_config: Path, target: Path,
                    max_length: int) -> Path:
    """``examples/qwen3-8b-peagle-single-chip.json``, read as data, pointed
    at this run's directories, with accumulation 2 (from 8), the row-sparse
    embedding update, one epoch, a log line per step and a checkpoint every
    2 steps. Its eval set is dropped: P-EAGLE has no eval pass."""
    raw = json.loads(PEAGLE_EXAMPLE.read_text())
    raw["run_id"] = "peagle"
    raw["output_dir"] = str(workdir / "runs")
    raw["model"].update(target_model_path=str(target),
                        draft_config_path=str(draft_config))
    raw["data"].update(train_data_path=str(workdir / "train"),
                       eval_data_path=None, max_length=max_length,
                       num_workers=2)
    raw["training"].update(num_epochs=1, accumulation_steps=ACCUM,
                           row_sparse_embedding=True, save_interval=1,
                           eval_interval=0, log_interval=1)
    raw["tracking"] = {"backend": "jsonl"}
    path = workdir / "run.json"
    path.write_text(json.dumps(raw, indent=2))
    return path


def peagle_window_grads(trainer, window) -> tuple:
    """:func:`window_grads` of a row-sparse run → (loss, the dense grads and
    the summed embedding rows under ``EMBED_PATH + "[rows]"``, the rows'
    ids); all on the host."""
    grads, stats = trainer.train_step.accumulate(
        trainer.state, stack_window(window), trainer.frozen)
    uids, rows = stats["sparse_embed"]
    grads[EMBED_PATH + "[rows]"] = rows
    return (float(stats["loss"] / stats["norm"]),
            {k: g.cpu() for k, g in grads.items()}, uids.cpu())


def timed_windows(trainer, sync, after_first=None) -> list:
    """The trainer's train step over every window of its loader, each timed
    to a device synchronise → per-step metrics and ``step_ms``;
    ``after_first(trainer)`` runs after step 1, outside the timing."""
    steps = []
    for stacked, _ids, _meta in trainer._accum_groups(trainer.train_loader):
        sync()
        t0 = time.perf_counter()
        trainer.state, metrics = trainer.train_step(trainer.state, stacked,
                                                    trainer.frozen)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append({"step": trainer.state.step, "step_ms": ms,
                      **{k: float(v) for k, v in metrics.items()}})
        if after_first is not None and len(steps) == 1:
            after_first(trainer)
    return steps


def run_peagle_training(cfg_path: Path, device, seed: int, workdir: Path, *,
                        max_length=1024, min_len=768, pack_len=(128, 256),
                        head_std=0.02, overrides=()) -> tuple:
    """Slice 4 end to end; returns the results and the launch counts of its
    main path (the ``cli train`` run), set to 0 just before it and read just
    after.

    The main path is ``cli.main(["train", ...])``: 2 optimizer steps with
    the row-sparse embedding update and checkpoints at steps 1 and 2. Then
    a fresh kernel-path trainer gives step 1's loss and gradients, runs the
    same 2 steps timed (which must reach the cli run's weights: two runs
    give the same bits), keeping the embedding after step 1, and the
    micro-step and optimizer-step timings; a trainer resumed from the
    step-1 checkpoint must reach the final weights bit-exactly; a trainer
    with the dense embedding update takes step 1, whose touched rows must
    match the row-sparse ones and whose untouched rows stay as they were;
    the plain path (the draft config's ``attention_backend: "dense"`` and
    the reference CE, same initial weights and samples) gives its step-1
    gradients and loss curve; last, one optimizer step with
    ``data.pack_documents``."""
    raw_cfg = json.loads(Path(cfg_path).read_text())
    cfg = PEagleConfig.from_dict(raw_cfg)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    write_features(workdir / "train", cfg, seed, PEAGLE_FILES, min_len,
                   max_length, response_only=True)
    write_features(workdir / "packed", cfg, seed + 200, PACK_FILES,
                   *pack_len, response_only=True)
    target = write_target_dir(workdir / "target", cfg.vocab_size,
                              cfg.resolved_target_hidden_size, device, seed,
                              head_std)
    run_json = peagle_run_json(workdir, cfg_path, target, max_length)
    dense_cfg = workdir / "draft-dense.json"
    dense_cfg.write_text(json.dumps({**raw_cfg, "attention_backend": "dense"}))
    runs = workdir / "runs"
    overrides = list(overrides)

    def trainer_for(*extra):
        config = load_config(str(run_json), overrides + list(extra))
        return build_training_run(config, device=None if on_card else device)

    def free():
        if on_card:
            torch.cuda.empty_cache()

    # the main path
    results = {}
    for fn in PEAGLE_COUNTERS.values():
        fn.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    device_args = [] if on_card else ["--device", str(device)]
    rc = cli.main(["train", "-c", str(run_json), *device_args,
                   *[a for o in overrides for a in ("--set", o)]])
    sync()
    counts = {n: fn.launches for n, fn in PEAGLE_COUNTERS.items()}
    if rc != 0:
        raise AssertionError(f"cli train exited {rc}")
    results["main_path_s"] = time.perf_counter() - t0
    if on_card:
        results["main_path_peak_bytes"] = torch.cuda.max_memory_allocated()
    kernel_steps = step_records(runs, "peagle")
    final_dir = Path(CheckpointManager.resolve_step_dir(str(runs)))
    results["checkpoint"] = {
        "dir": final_dir.name,
        "bytes": sum(f.stat().st_size for f in final_dir.rglob("*")
                     if f.is_file()),
    }
    final = CheckpointManager.load_state(str(final_dir))["params"]
    shutil.rmtree(final_dir)

    # a fresh kernel-path trainer: step 1's gradients, the same 2 steps
    # timed, then the micro-step and optimizer timings
    trainer = trainer_for('run_id="kernel"', "training.save_interval=0")
    window = first_window(trainer)
    init_embed = trainer.state.params[EMBED_PATH].detach().to("cpu",
                                                                copy=True)
    loss_k, grads_k, uids = peagle_window_grads(trainer, window)
    after_step1 = {}

    def keep_embed(t):
        after_step1["sparse"] = t.state.params[EMBED_PATH].detach().to(
            "cpu", copy=True)

    timed = timed_windows(trainer, sync, keep_embed)
    repeat_exact = all(torch.equal(trainer.state.params[n].detach().cpu(), w)
                       for n, w in final.items())
    if not repeat_exact:
        raise AssertionError("a second run of the same 2 steps did not "
                             "reach the cli run's weights bit-exactly")
    results["repeat_bit_exact"] = repeat_exact
    results["step_ms"] = [r["step_ms"] for r in timed]
    results["step_ms_after_step_1"] = statistics.median(
        results["step_ms"][1:])
    del timed
    results.update(measure_kernel_path(trainer, window, sync))
    del trainer
    free()

    # resume from the step-1 checkpoint: the final weights bit-exactly
    resumed = trainer_for('run_id="resumed"', "training.save_interval=0",
                          f"training.resume_from={runs / 'peagle-step1'}")
    resumed.fit()
    exact = all(torch.equal(resumed.state.params[n].detach().cpu(), w)
                for n, w in final.items())
    worst = max(rel_max_err(resumed.state.params[n].detach().cpu(), w)
                for n, w in final.items())
    if not exact:
        raise AssertionError(f"resumed weights differ from the uninterrupted "
                             f"run's (max|err| / max|w| {worst})")
    results["resume"] = {"from": "peagle-step1", "steps": resumed.state.step,
                         "bit_exact": exact, "max_rel_err": worst}
    del resumed, final
    shutil.rmtree(runs, ignore_errors=True)
    free()

    # step 1 with the dense embedding update: the same touched rows, and no
    # other row moves in either run
    dense = trainer_for('run_id="dense_embed"', "training.save_interval=0",
                        "training.row_sparse_embedding=false")
    dense.state, _ = dense.train_step(dense.state, stack_window(window),
                                      dense.frozen)
    after_step1["dense"] = dense.state.params[EMBED_PATH].detach().to(
        "cpu", copy=True)
    del dense
    free()
    touched = torch.zeros(init_embed.shape[0], dtype=torch.bool)
    touched[uids] = True
    moved = {k: e - init_embed for k, e in after_step1.items()}
    for name, delta in moved.items():
        if delta[~touched].any():
            raise AssertionError(f"the {name} embedding update moved a row "
                                 "no token of the window embeds")
    diff = max_err(after_step1["sparse"][touched],
                   after_step1["dense"][touched])
    update = float(moved["dense"][touched].abs().max())
    embed_err = diff / float(after_step1["dense"][touched].abs().max())
    check("row-sparse vs dense embedding rows (max|err| / max|row|)",
          embed_err, EMBED_UPDATE_RTOL)
    results["embedding_update"] = {
        "touched_rows": int(touched.sum()), "max_update": update,
        "sparse_vs_dense_rel_err": embed_err, "rtol": EMBED_UPDATE_RTOL,
        "err_over_max_update": diff / update,
        "untouched_rows_unchanged": True}
    del after_step1, moved, init_embed

    # the plain path from the same initial weights and samples: the dense
    # masked attention and the reference CE, no kernel of the port
    plain = trainer_for(f'model.draft_config_path="{dense_cfg}"',
                        'run_id="plain"', "training.save_interval=0")
    plain.strategy.model.loss_fn = log_softmax_loss_reference
    for fn in PEAGLE_COUNTERS.values():
        fn.launches = 0
    loss_p, grads_p, uids_p = peagle_window_grads(plain, window)
    if not torch.equal(uids, uids_p):
        raise AssertionError("the plain path embedded other rows")
    check("step-1 loss, kernel vs plain", abs(loss_k - loss_p) / abs(loss_p),
          TRAIN_STEP1_RTOL)
    results["step1"] = {"loss": loss_k, "plain_loss": loss_p}
    results["step1_grads"] = compare_grads(grads_k, grads_p)
    del grads_k, grads_p
    plain_steps = train_windows(plain)
    results["plain_path_launches"] = {n: fn.launches
                                      for n, fn in PEAGLE_COUNTERS.items()}
    if any(results["plain_path_launches"].values()):
        raise AssertionError("the plain path launched a kernel of the port")
    del plain
    free()
    results["loss_curve"] = compare_curves(kernel_steps, plain_steps)
    results["optimizer_steps"] = len(kernel_steps)
    results["micro_batches"] = len(kernel_steps) * ACCUM
    t = load_config(str(run_json), overrides).training
    t_rows = sum(cod_capacities(max_length, t.num_depths,
                                t.down_sample_ratio, t.down_sample_ratio_min))
    ms = results["micro_step_ms"]
    results["sampled_rows_per_micro_batch"] = BATCH * t_rows
    results["tokens_per_s"] = BATCH * max_length / (ms / 1e3)
    results["sampled_rows_per_s"] = BATCH * t_rows / (ms / 1e3)

    # one optimizer step over packed rows: 4 documents to a row
    packed = trainer_for('run_id="packed"', "training.save_interval=0",
                         "data.pack_documents=true",
                         f"data.docs_per_row={DOCS_PER_ROW}",
                         f'data.train_data_path="{workdir / "packed"}"')
    batches = first_window(packed)
    docs = [int((b["lengths"] > 0).sum()) for b in batches]
    if docs != [BATCH * DOCS_PER_ROW] * ACCUM:
        raise AssertionError(f"packed micro-batches hold {docs} documents")
    steps = timed_windows(packed, sync)
    if len(steps) != 1 or not math.isfinite(steps[0]["train/loss"]):
        raise AssertionError(f"packed step: {steps}")
    results["packed_step"] = {
        "documents_per_micro_batch": docs, "loss": steps[0]["train/loss"],
        "grad_norm": steps[0]["train/grad_norm"],
        "step_ms": steps[0]["step_ms"]}
    del packed
    free()
    shutil.rmtree(runs, ignore_errors=True)
    return results, counts


# --------------------------------------------------------------------------
# slice 5: the offset-causal LSE ring-hop kernels and USP training
# --------------------------------------------------------------------------

USP_EXAMPLE = REPO / "examples" / "qwen3-8b-eagle3-usp-32k.json"
LSE_KERNELS = ("lse_attention_fwd", "lse_attention_bwd_dq",
               "lse_attention_bwd_dkv")
#: the USP training phase: examples/qwen3-8b-eagle3-usp-32k.json cut to
#: 4096 tokens (at 8192 the 4 ranks ran out of the card's 80 GB: 18.9 GB
#: allocated a rank in the first forward), a 2×2 grid, accumulation 2 and
#: 8 files (4 steps)
USP_GRID, USP_MAX_LEN, USP_MIN_LEN, USP_FILES = (2, 2), 4096, 3584, 4
#: when the 4 ranks share one card (host-staged gloo, 10-13 s a step): 2
#: steps of one micro-batch over 2 files, and no 4-rank resume (the mesh
#: phase resumes its 4 EAGLE3 ranks from a sharded checkpoint), for the
#: script's 1,200 s
USP_ONE_CARD_ACCUM, USP_ONE_CARD_FILES = 1, 2
#: a ring chunk of the USP phase: U·S_loc = 2048 positions
USP_CHUNK = USP_MAX_LEN // USP_GRID[1]
#: (name, BH, S, D, row_off, col_off, padded key tail), one rank's 16 heads
#: of 32 after the Ulysses exchange. Cases (a)-(e) at a ring chunk of
#: S_g = 4096 (8192 tokens on a 2×2 grid): (a) the own chunk; (b) an
#: earlier chunk (every key allowed); (c) a later chunk (no key: out
#: exactly 0, lse exactly -1e30); (d) a key-padding tail at a ragged S;
#: (e) head dim 64. Then the three hops of the USP phase's main path, at
#: its chunk of USP_CHUNK positions
LSE_CASES = (
    ("a_own", 16, 4096, 128, 4096, 4096, 0),
    ("b_earlier", 16, 4096, 128, 4096, 0, 0),
    ("c_later", 16, 4096, 128, 0, 4096, 0),
    ("d_padded_s4000", 16, 4000, 128, 0, 0, 300),
    ("e_head_dim_64", 16, 4096, 64, 4096, 4096, 0),
    ("main_own", 16, USP_CHUNK, 128, USP_CHUNK, USP_CHUNK, 0),
    ("main_earlier", 16, USP_CHUNK, 128, USP_CHUNK, 0, 0),
    ("main_later", 16, USP_CHUNK, 128, 0, USP_CHUNK, 0),
)
#: the hops one TTT step launches on the 4 ranks of the phase's 2×2 grid:
#: each ring rank attends its own chunk, ring rank 1 an earlier one and
#: ring rank 0 a later one
LSE_MAIN_PATH = ("main_own", "main_own", "main_earlier", "main_later")
USP_TIMEOUT = 900  # seconds for the 4 ranks
USP_COUNTERS = {
    "lse_attention_fwd": lse_attention_cuda.lse_attention_fwd,
    "lse_attention_bwd_dq": lse_attention_cuda.lse_attention_bwd_dq,
    "lse_attention_bwd_dkv": lse_attention_cuda.lse_attention_bwd_dkv,
    **KERNEL_COUNTERS,
}


def lse_case_inputs(gen, bh, s, d, pad):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    valid = torch.ones((bh, s), dtype=torch.int32, device="cuda")
    if pad:
        valid[:, s - pad:] = 0
    return rnd(bh, s, d), rnd(bh, s, d), rnd(bh, s, d), valid


def lse_allowed_pairs(valid, row_off, col_off) -> int:
    """P: the allowed (row, key) pairs over all heads of these inputs."""
    bh, s = valid.shape
    counts = torch.cumsum((valid != 0).to(torch.int64), dim=1)
    lim = torch.arange(s, device=valid.device) + row_off - col_off
    seen = counts.gather(1, lim.clamp(0, s - 1).expand(bh, s))
    return int(torch.where(lim >= 0, seen, 0).sum())


def lse_bounds(q, valid, row_off, col_off) -> dict:
    """The least times of the three LSE kernels for these inputs: each
    input read once and each output written once over the card's memory
    rate; the tensor-core products over P at the bf16 peak (2·D operations
    per pair and product: the forward's two, dq's three, dk/dv's four).
    With no allowed pair (a later chunk) the function reads nothing and
    only writes its outputs: out and lse, dq, dk and dv."""
    bh, s, d = q.shape
    pairs = lse_allowed_pairs(valid, row_off, col_off)
    t = bh * s * d * 2             # one of q, k, v, out, dO, dq, dk, dv
    stat = bh * s * 4              # one of lse, dstat
    vbytes = valid.numel() * 4

    def bound(nbytes, ops):
        return {"bytes_ms": nbytes / PEAK_HBM * 1e3,
                "ops_ms": ops / PEAK_BF16 * 1e3}

    if pairs == 0:
        return {
            "pairs": 0,
            "lse_attention_fwd": bound(t + stat, 0),
            "lse_attention_bwd_dq": bound(t, 0),
            "lse_attention_bwd_dkv": bound(2 * t, 0),
        }
    return {
        "pairs": pairs,
        "lse_attention_fwd": bound(4 * t + stat + vbytes, 4 * d * pairs),
        "lse_attention_bwd_dq": bound(5 * t + 2 * stat + vbytes,
                                      6 * d * pairs),
        "lse_attention_bwd_dkv": bound(6 * t + 2 * stat + vbytes,
                                       8 * d * pairs),
    }


def lse_sdpa_yardstick(q, k, v, valid, row_off, col_off, dout):
    """One library call computing the same function, and its backward: SDPA
    with the boolean offset-causal mask (timed only: a row with no allowed
    key has no exact-zero rule there)."""
    s = q.shape[1]
    idx = torch.arange(s, device=q.device)
    mask = ((idx[None, :] + col_off <= idx[:, None] + row_off)[None]
            & (valid != 0)[:, None, :])
    qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))

    def forward():
        return F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask)

    out = forward()
    return forward, lambda: torch.autograd.grad(out, (qr, kr, vr), dout,
                                                retain_graph=True)


def lse_flash_yardstick(q, k, v, row_off, col_off, dout):
    """A second yardstick, timed only: the library flash kernel over the
    hop's pairs where it takes them without a mask (``is_causal`` for an
    own hop, no mask for an earlier one; key_valid dropped, so on a padded
    tail it computes more pairs) → (forward, backward), or None where it
    cannot (a later hop has no pair; a partial overlap; no flash kernel
    for these inputs on this build)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    s_q, s_k = q.shape[1], k.shape[1]
    if row_off == col_off and s_q == s_k:
        causal = True
    elif col_off + s_k - 1 <= row_off:
        causal = False
    else:
        return None
    qr, kr, vr = (x[None].detach().requires_grad_(True) for x in (q, k, v))

    def forward():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qr, kr, vr,
                                                  is_causal=causal)

    try:
        out = forward()
    except RuntimeError:
        return None
    return forward, lambda: torch.autograd.grad(out, (qr, kr, vr), dout[None],
                                                retain_graph=True)


def lse_reached_keys(valid, s_q, row_off, col_off) -> torch.Tensor:
    """[BH, Sk] bool: the keys some row of the hop may attend (valid, and at
    or before the last row's limit)."""
    idx = torch.arange(valid.shape[1], device=valid.device)
    return (valid != 0) & (idx + col_off <= s_q - 1 + row_off)[None]


def lse_kernel_phase(gen) -> list:
    """The three LSE kernels against their plain versions in cases
    (a)-(e), in bf16: the output and every gradient within ATTN_TOL of the
    plain version's largest value, lse within STAT_RTOL (|err| / (1 +
    |lse|)) on rows with an allowed key, and rows without one exactly 0 and
    -1e30 (case c: every row) with dq exactly 0; dk/dv exactly 0 on keys
    no row reaches; both backward kernels twice with the same bits. Each
    case is timed (kernel one launch at a time and 30 back to back, plain,
    the masked SDPA yardstick and the flash one) beside its bound; the
    kernels line averages the hops of the USP phase's main path
    (LSE_MAIN_PATH)."""
    lac = lse_attention_cuda
    results = {}
    for name, bh, s, d, row_off, col_off, pad in LSE_CASES:
        q, k, v, valid = lse_case_inputs(gen, bh, s, d, pad)
        out, lse = lac.lse_attention_fwd(q, k, v, valid, row_off, col_off)
        dout = torch.randn(out.shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        dlse = torch.randn(lse.shape, generator=gen, device="cuda")
        grads = lac.lse_attention_bwd(q, k, v, valid, row_off, col_off, out,
                                      lse, dout, dlse)
        torch.cuda.synchronize()
        ref, ref_lse = lac.flash_attention_lse_plain(q, k, v, valid, row_off,
                                                     col_off)
        ref_grads = lac.flash_attention_lse_backward_plain(
            q, k, v, valid, row_off, col_off, out, lse, dout, dlse)
        empty = ref_lse[..., 0] == lac.NEG_INF
        if out[empty].any() or not torch.equal(lse[empty], ref_lse[empty]):
            raise AssertionError(f"case {name}: rows with no allowed key are "
                                 "not out = 0, lse = -1e30")
        if grads[0][empty].any():
            raise AssertionError(f"case {name}: dq of rows with no allowed "
                                 "key is not 0")
        unreached = ~lse_reached_keys(valid, s, row_off, col_off)
        if grads[1][unreached].any() or grads[2][unreached].any():
            raise AssertionError(f"case {name}: dk/dv of keys no row reaches "
                                 "are not 0")
        if name.endswith("later") and not (
                bool(empty.all()) and not any(g.any() for g in grads)):
            raise AssertionError("a later-chunk hop wrote a value other than "
                                 "out = 0, lse = -1e30 and zero gradients")
        pairs = {
            "lse_attention_fwd": [(out, ref)],
            "lse_attention_bwd_dq": [(grads[0], ref_grads[0])],
            "lse_attention_bwd_dkv": list(zip(grads[1:], ref_grads[1:])),
        }
        errs = {kname: max(rel_max_err(a, r) if r.any() else max_err(a, r)
                           for a, r in v_) for kname, v_ in pairs.items()}
        abs_errs = {kname: max(max_err(a, r) for a, r in v_)
                    for kname, v_ in pairs.items()}
        for kernel, err in errs.items():
            check(f"{kernel} case {name} (max|err| / max|ref|)", err,
                  ATTN_TOL)
        live = ~empty
        errs["lse"] = (max_err(lse[live], ref_lse[live]) / (
            1.0 + float(ref_lse[live].abs().max())) if live.any() else 0.0)
        check(f"lse case {name}", errs["lse"], STAT_RTOL)
        dstat = lac.backward_dstat(out, dout, dlse)
        bwd_args = (q, k, v, valid, row_off, col_off, dout, lse, dstat)
        check_repeat(f"lse_attention_fwd case {name}",
                     lambda: lac.lse_attention_fwd(q, k, v, valid, row_off,
                                                   col_off))
        check_repeat(f"lse_attention_bwd_dq case {name}",
                     lambda: (lac.lse_attention_bwd_dq(*bwd_args),))
        check_repeat(f"lse_attention_bwd_dkv case {name}",
                     lambda: lac.lse_attention_bwd_dkv(*bwd_args))
        launch = {
            "lse_attention_fwd": lambda: lac.lse_attention_fwd(
                q, k, v, valid, row_off, col_off),
            "lse_attention_bwd_dq": lambda: lac.lse_attention_bwd_dq(
                *bwd_args),
            "lse_attention_bwd_dkv": lambda: lac.lse_attention_bwd_dkv(
                *bwd_args),
        }
        lib_fwd, lib_bwd = lse_sdpa_yardstick(q, k, v, valid, row_off,
                                              col_off, dout)
        flash = lse_flash_yardstick(q, k, v, row_off, col_off, dout)
        row = {
            "phase": "kernel", "name": "lse_attention", "case": name,
            "BH": bh, "S": s, "D": d, "row_off": row_off, "col_off": col_off,
            "padded_keys": pad, "empty_rows": int(empty.sum()),
            "unreached_keys": int(unreached.sum()),
            "fwd_repeat": "bit-exact", "dq_repeat": "bit-exact",
            "dkv_repeat": "bit-exact",
            "rel_err": errs, "max_abs_err": abs_errs,
            "tol": {"out_and_grads": f"{ATTN_TOL} * max|ref|",
                    "lse": f"{STAT_RTOL} * (1 + max|lse|)",
                    "empty_rows": "out and dq exactly 0, lse exactly -1e30",
                    "unreached_keys": "dk, dv exactly 0"},
            "ms": {kname: median_ms(fn) for kname, fn in launch.items()},
            "run_ms": {kname: run_ms(fn) for kname, fn in launch.items()},
            "plain_fwd_ms": median_ms(lambda: lac.flash_attention_lse_plain(
                q, k, v, valid, row_off, col_off)),
            "plain_bwd_ms": median_ms(
                lambda: lac.flash_attention_lse_backward_plain(
                    q, k, v, valid, row_off, col_off, out, lse, dout, dlse)),
            "library_fwd_ms": median_ms(lib_fwd),
            "library_bwd_ms": median_ms(lib_bwd),
            # a hop with no allowed pair leaves the library nothing to do
            "library_flash_fwd_ms": (median_ms(flash[0]) if flash else
                                     0.0 if empty.all() else None),
            "library_flash_bwd_ms": (median_ms(flash[1]) if flash else
                                     0.0 if empty.all() else None),
            "bound": lse_bounds(q, valid, row_off, col_off),
        }
        emit(row)
        results[name] = row
        del q, k, v, valid, out, lse, grads, ref, ref_lse, ref_grads, dout
        del bwd_args, lib_fwd, lib_bwd, flash, launch
        torch.cuda.empty_cache()

    main = [results[name] for name in LSE_MAIN_PATH]
    lines = []
    for kernel, line in zip(LSE_KERNELS, (471, 521, 563)):
        backward = kernel != "lse_attention_fwd"
        plain = "plain_bwd_ms" if backward else "plain_fwd_ms"
        library = "library_bwd_ms" if backward else "library_fwd_ms"
        flash = ("library_flash_bwd_ms" if backward
                 else "library_flash_fwd_ms")
        bound_ms, bound_by = mean_bound([r["bound"][kernel] for r in main])
        flash_ms = [r[flash] for r in main]
        lines.append({
            "name": kernel,
            "route": "cuda",
            "source": "specforge_tpu_torch/csrc/lse_attention.cu",
            "replaces": f"specforge_tpu/ops/attention_pallas.py:{line}",
            "max_abs_err": max(r["max_abs_err"][kernel]
                               for r in results.values()),
            "rel_err": max(r["rel_err"][kernel] for r in results.values()),
            "tol": f"{ATTN_TOL} * max|ref|",
            # per launch, averaged over the main path's hops (two own
            # chunks, one earlier, one later), one at a time and back to
            # back; the plain backward and the library backwards compute
            # every gradient at once, and stand beside both backward
            # kernels; the flash yardstick counts the later hop as 0 ms
            "ms": sum(r["ms"][kernel] for r in main) / len(main),
            "run_ms": sum(r["run_ms"][kernel] for r in main) / len(main),
            "plain_ms": sum(r[plain] for r in main) / len(main),
            "library_ms": sum(r[library] for r in main) / len(main),
            "library_flash_ms": (None if None in flash_ms
                                 else sum(flash_ms) / len(main)),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        })
    return lines


def usp_run_json(workdir: Path, draft_config: Path, target: Path,
                 max_length: int, accum: int = ACCUM,
                 save_interval: int = 1) -> Path:
    """``examples/qwen3-8b-eagle3-usp-32k.json``, read as data, pointed at
    this run's directories and cut to ``max_length`` tokens, a 2×2 grid,
    accumulation ``accum``, one epoch, a log line per step and a checkpoint
    every ``save_interval`` steps (0: at the end only)."""
    raw = json.loads(USP_EXAMPLE.read_text())
    raw["run_id"] = "usp"
    raw["output_dir"] = str(workdir / "runs")
    raw["model"].update(target_model_path=str(target),
                        draft_config_path=str(draft_config))
    raw["data"].update(train_data_path=str(workdir / "train"),
                       max_length=max_length, num_workers=2)
    raw["training"].update(sp_ulysses_size=USP_GRID[0],
                           sp_ring_size=USP_GRID[1], num_epochs=1,
                           accumulation_steps=accum,
                           save_interval=save_interval, log_interval=1)
    raw["tracking"] = {"backend": "jsonl"}
    path = workdir / "run.json"
    path.write_text(json.dumps(raw, indent=2))
    return path


def weights_digest(params: dict) -> str:
    """sha256 over every trainable tensor's bytes, in name order."""
    h = hashlib.sha256()
    for name in sorted(params):
        h.update(name.encode())
        h.update(params[name].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def usp_rank(workdir: Path, device, overrides=()) -> None:
    """One rank of the USP phase (``chip_smoke.py --usp-rank WORKDIR``,
    started 4 times with the SPECFORGE_* env): ``cli.main(["train", ...])``
    with its launch counts set to 0 just before and read just after, then a
    trainer resumed from the step-1 checkpoint (a fresh one when the ranks
    share one card) — its step-1 loss and gradients
    first, from the same initial weights — its micro-step, optimizer-step
    and whole-step times, the collectives' share and the memory;
    everything into ``rank{N}.json`` (rank 0 also writes the step-1
    gradients)."""
    from specforge_tpu_torch.application import composition
    from specforge_tpu_torch.parallel import usp
    from specforge_tpu_torch.parallel.multihost import (
        barrier,
        maybe_initialize_distributed,
        process_index,
        shutdown,
    )

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    device = maybe_initialize_distributed(device)
    rank = process_index()
    run_json = workdir / "run.json"
    overrides = list(overrides)
    device_args = [] if on_card else ["--device", str(device)]
    built = []
    build = composition.build_training_run

    def capture(*args, **kwargs):
        trainer = build(*args, **kwargs)
        step, losses = trainer.train_step, []

        def recorded(state, batch, frozen):
            state, metrics = step(state, batch, frozen)
            losses.append(float(metrics["train/loss"]))
            return state, metrics

        recorded.__dict__.update(step.__dict__)
        trainer.train_step, trainer.losses = recorded, losses
        built.append(trainer)
        return trainer

    def trainer_for(*extra):
        config = load_config(str(run_json), overrides + list(extra))
        return build_training_run(config, device=None if on_card else device)

    try:
        composition.build_training_run = capture
        out = {"rank": rank}
        for fn in USP_COUNTERS.values():
            fn.launches = 0
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        rc = cli.main(["train", "-c", str(run_json), *device_args,
                       *[a for o in overrides for a in ("--set", o)]])
        sync()
        out["cli_train_s"] = time.perf_counter() - t0
        out["launches"] = {n: fn.launches for n, fn in USP_COUNTERS.items()}
        composition.build_training_run = build
        if rc != 0:
            raise AssertionError(f"rank {rank}: cli train exited {rc}")
        trainer = built.pop()
        out.update(
            transport=trainer.mesh.transport, chunk=trainer.mesh.chunk_index,
            writes_checkpoints=trainer.checkpoints.primary,
            tracks=type(trainer.tracker).__name__ != "NoOpTracker",
            losses=trainer.losses, digest=weights_digest(trainer.state.params))
        if on_card:
            out["cli_train_peak_bytes"] = torch.cuda.max_memory_allocated()
        del trainer
        gc.collect()  # the recording wrapper makes a reference cycle
        if on_card:
            torch.cuda.empty_cache()

        # resumed from step 1: first step 1's loss and gradients from the
        # same initial weights, then the last step
        resume = not share_one_card(device, USP_GRID[0] * USP_GRID[1])
        resumed = trainer_for(
            'run_id="usp_resumed"', "training.save_interval=0",
            f'output_dir="{workdir / "resumed"}"',
            *[f"training.resume_from={workdir / 'runs' / 'usp-step1'}"]
            * resume)
        window = first_window(resumed)
        loss, grads = window_grads(resumed, window)
        out["step1_loss"] = loss
        if rank == 0:
            torch.save({k: g.cpu() for k, g in grads.items()},
                       workdir / "usp_step1_grads.pt")
        del grads
        if resume:
            resumed.fit()
            out["resumed_digest"] = weights_digest(resumed.state.params)
            out["resumed_steps"] = resumed.state.step

        # timings on the resumed trainer (its state changes from here): the
        # micro-steps of one window, the update alone, then two whole steps
        # (the micro-steps, the gradient all-reduce and the update), each
        # with the host seconds spent in collectives
        step = resumed.train_step

        def timed(fn):
            sync()
            usp.reset_collective_stats()
            t0 = time.perf_counter()
            result = fn()
            sync()
            return (result, (time.perf_counter() - t0) * 1e3,
                    usp.COLLECTIVES["seconds"] * 1e3)

        # each collective waits for the card around it, so that its time
        # is its own under NCCL too (host-staged gloo waits anyway)
        usp.TIMED = True
        micro = [timed(lambda: step.micro_step(resumed.state, tensors,
                                               resumed.frozen))
                 for tensors in window]
        usp.TIMED = False
        grads = micro[-1][0][0]
        out["micro_step_ms_all"] = [m[1] for m in micro]
        out["micro_step_ms"] = micro[-1][1]
        out["collectives_ms_per_micro_step"] = micro[-1][2]
        out["collective_bytes_per_micro_step"] = usp.COLLECTIVES["bytes"]
        # the update of one micro-step's gradients: the same work as the
        # step's (global norm, clip, AdamW), no collective
        out["optimizer_step_ms"] = statistics.median(
            timed(lambda: step.update(resumed.state, grads, {}))[1]
            for _ in range(3))
        del micro, grads
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        (resumed.state, _), ms, coll = timed(lambda: resumed.train_step(
            resumed.state, stack_window(window), resumed.frozen))
        out["whole_steps"] = [{"ms": ms, "collectives_ms": coll}]
        if on_card:
            out["train_step_peak_bytes"] = torch.cuda.max_memory_allocated()
        barrier("usp-memory")  # every rank holds its state now
        if on_card:
            free, total = torch.cuda.mem_get_info()
            out["card_used_bytes"] = total - free
        barrier("usp-done")
        (workdir / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        composition.build_training_run = build
        shutdown()


def start_usp_ranks(workdir: Path, device, overrides) -> list:
    """Start the ranks of the USP phase, each ``chip_smoke.py --usp-rank``
    with the SPECFORGE_* env, wait for all within USP_TIMEOUT (killing them
    past it) → their ``rank{N}.json`` records; raise with the ranks' logs if
    one failed."""
    return start_ranks(workdir, device, overrides, "--usp-rank",
                       USP_GRID[0] * USP_GRID[1], USP_TIMEOUT, "USP")


def share_one_card(device, ranks: int) -> bool:
    """Whether ``ranks`` processes on ``device`` share one card (there are
    fewer cards than ranks)."""
    return device.type == "cuda" and torch.cuda.device_count() < ranks


def start_ranks(workdir: Path, device, overrides, flag: str, ranks: int,
                timeout: float, what: str) -> list:
    """Start ``ranks`` processes of ``chip_smoke.py <flag> WORKDIR`` with
    the SPECFORGE_* env, wait for all within ``timeout`` seconds (killing
    them past it) → their ``rank{N}.json`` records; raise with the ranks'
    logs if one failed."""
    return join_ranks(launch_ranks(workdir, device, overrides, flag, ranks),
                      timeout, what)


def launch_ranks(workdir: Path, device, overrides, flag: str, ranks: int
                 ) -> dict:
    """Start ``ranks`` processes of ``chip_smoke.py <flag> WORKDIR`` with
    the SPECFORGE_* env, and return at once (``join_ranks`` waits)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, str(Path(__file__).resolve()), flag,
           str(workdir), "--seed", "0"]
    if device.type != "cuda":
        cmd += ["--device", str(device)]
    cmd += [a for o in overrides for a in ("--set", o)]
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, SPECFORGE_COORDINATOR=f"localhost:{port}",
                   SPECFORGE_NUM_PROCESSES=str(ranks),
                   SPECFORGE_PROCESS_ID=str(rank))
        if device.type == "cpu":  # the ranks share the host's cores
            env["OMP_NUM_THREADS"] = "1"
        else:  # the ranks share the card's memory: no stranded segments
            env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        log = open(workdir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(cmd, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return {"workdir": workdir, "procs": procs,
            "deadline_from": time.monotonic()}


def kill_ranks(launched: dict) -> None:
    for proc, log in launched["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def join_ranks(launched: dict, timeout: float, what: str) -> list:
    """Wait for the ranks of ``launch_ranks`` within ``timeout`` seconds of
    their launch (killing them past it) → their ``rank{N}.json`` records;
    raise with the ranks' logs if one failed."""
    workdir, procs = launched["workdir"], launched["procs"]
    ranks = len(procs)
    failed = []
    deadline = launched["deadline_from"] + timeout
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                if proc.wait(timeout=max(deadline - time.monotonic(), 1)):
                    failed.append(rank)
            except subprocess.TimeoutExpired:
                failed.append(rank)
                break
    finally:
        kill_ranks(launched)
    if failed:
        def excerpt(r):  # the rank's JSON progress lines, then its tail
            text = (workdir / f"rank{r}.log").read_text()
            return "".join(line for line in text.splitlines(True)
                           if line.startswith("{")) + text[-3000:]

        logs = "\n".join(f"--- rank {r}\n{excerpt(r)}" for r in range(ranks))
        raise AssertionError(f"{what} ranks {failed} failed or timed out\n"
                             f"{logs}")
    return [json.loads((workdir / f"rank{r}.json").read_text())
            for r in range(ranks)]


def check_usp_counts(rank_launches: list, micro_batches: int) -> None:
    """On every rank: TTT·R launches of each LSE kernel and TTT of each
    fused CE kernel per micro-batch, none of the TTT kernels."""
    ring = USP_GRID[1]
    for rank, launches in enumerate(rank_launches):
        for name, n in launches.items():
            per = (TTT * ring if name.startswith("lse") else
                   TTT if name.startswith("fused_ce") else 0)
            if n != per * micro_batches:
                raise AssertionError(
                    f"rank {rank}: {name} launched {n} times, "
                    f"expected {per * micro_batches} ({per} per micro-batch)")


def run_usp_training(cfg_path: Path, device, seed: int, workdir: Path, *,
                     max_length=USP_MAX_LEN, min_len=USP_MIN_LEN,
                     head_std=0.02, overrides=()) -> tuple:
    """Slice 5 end to end → (results, the launch counts of the main path
    summed over the ranks).

    The main path is ``cli.main(["train", ...])`` on 4 ranks of a 2×2 grid
    (``start_usp_ranks``; over host-staged gloo when they share one card):
    2 optimizer steps with checkpoints at steps 1 and 2. The ranks must
    report the same per-step loss and bit-identical final weights, only
    rank 0 may write, and a 4-rank resume from step 1 must reach the final
    weights bit-exactly. When the ranks share one card the steps take one
    micro-batch each, the run checkpoints at its end only and no rank
    resumes (``USP_ONE_CARD_*``). Then one process runs the same batches
    from the same initial weights with the TTT kernels
    (``attention_backend: "pallas"``, B = 1, S = ``max_length``): its
    step-1 loss and gradients and its loss curve against the USP run's, and
    its timings."""
    cfg = Eagle3Config.from_file(cfg_path)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    resume = not share_one_card(device, USP_GRID[0] * USP_GRID[1])
    accum, files = (ACCUM, USP_FILES) if resume else (
        USP_ONE_CARD_ACCUM, USP_ONE_CARD_FILES)
    write_features(workdir / "train", cfg, seed, files, min_len, max_length)
    target = write_target_dir(workdir / "target", cfg.vocab_size,
                              cfg.resolved_target_hidden_size, device, seed,
                              head_std)
    run_json = usp_run_json(workdir, cfg_path, target, max_length, accum,
                            save_interval=int(resume))
    overrides = list(overrides)
    results = {}
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        results["parent_before_ranks"] = {
            "allocated_bytes": torch.cuda.memory_allocated(),
            "reserved_bytes": torch.cuda.memory_reserved(),
            "card_used_bytes": total - free}
    t0 = time.perf_counter()
    records = start_usp_ranks(workdir, device, overrides)
    results["ranks_s"] = time.perf_counter() - t0
    rank0 = records[0]
    steps = step_records(workdir / "runs", "usp")
    micro_batches = len(steps) * accum
    for rec in records:
        if rec["losses"] != rank0["losses"]:
            raise AssertionError(f"rank {rec['rank']}: per-step losses "
                                 f"{rec['losses']} != rank 0's")
        if rec["digest"] != rank0["digest"]:
            raise AssertionError(f"rank {rec['rank']}: final weights differ "
                                 "from rank 0's")
        if resume and rec["resumed_digest"] != rank0["digest"]:
            raise AssertionError(f"rank {rec['rank']}: the resume from step 1 "
                                 "did not reach the final weights bit-exactly")
        if rec["step1_loss"] != rank0["step1_loss"]:
            raise AssertionError(f"rank {rec['rank']}: step-1 loss differs")
    if [r["step"] for r in steps] != list(range(1, len(steps) + 1)) or [
            r["train/loss"] for r in steps] != rank0["losses"]:
        raise AssertionError("rank 0's tracker disagrees with its steps")
    roles = [(r["writes_checkpoints"], r["tracks"]) for r in records]
    if roles != [(True, True)] + [(False, False)] * (len(records) - 1):
        raise AssertionError(f"IO roles {roles}: only rank 0 writes")
    written = sorted(p.name for p in (workdir / "runs").iterdir())
    if written != ["usp-step1"] * resume + [
            "usp-step2", "usp.latest", "usp.metrics.jsonl",
            "usp.vocab_mapping.npz"]:
        raise AssertionError(f"the USP run wrote {written}")
    grads_usp = torch.load(workdir / "usp_step1_grads.pt", weights_only=True)
    for name in ("runs", "resumed"):
        shutil.rmtree(workdir / name, ignore_errors=True)

    # one process, the same batches and initial weights, the TTT kernels
    config = load_config(str(run_json), overrides + [
        'run_id="single"', 'training.attention_backend="pallas"',
        "training.sp_ulysses_size=1", "training.sp_ring_size=1",
        "training.save_interval=0"])
    single = build_training_run(config, device=None if on_card else device)
    window = first_window(single)
    loss_s, grads_s = window_grads(single, window)
    check("step-1 loss, USP vs one process",
          abs(rank0["step1_loss"] - loss_s) / abs(loss_s), TRAIN_STEP1_RTOL)
    results["step1"] = {"loss": rank0["step1_loss"], "single_loss": loss_s}
    results["step1_grads"] = compare_grads(
        grads_usp, {k: g.cpu() for k, g in grads_s.items()})
    del grads_s, grads_usp
    single_steps = train_windows(single)
    curve = []
    for k, p in zip(steps, single_steps, strict=True):
        rel = abs(k["train/loss"] - p["train/loss"]) / abs(p["train/loss"])
        if not (math.isfinite(k["train/loss"])
                and math.isfinite(p["train/loss"])):
            raise AssertionError(f"step {k['step']}: loss not finite")
        check(f"step {k['step']} train/loss, USP vs one process", rel,
              TRAIN_STEP1_RTOL if k["step"] == 1 else TRAIN_DRIFT_RTOL)
        curve.append({"step": k["step"], "loss": k["train/loss"],
                      "single_loss": p["train/loss"], "rel_diff": rel,
                      "grad_norm": k["train/grad_norm"],
                      "single_grad_norm": p["train/grad_norm"]})
    results["loss_curve"] = curve
    whole = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        single.state, _ = single.train_step(single.state, stack_window(window),
                                            single.frozen)
        sync()
        whole.append((time.perf_counter() - t0) * 1e3)
    single_results = measure_kernel_path(single, window, sync)
    single_results["whole_step_ms_all"] = whole
    del single
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    tokens = accum * max_length  # the global sequence of a step
    whole_usp = statistics.median(
        [statistics.median(w["ms"] for w in r["whole_steps"])
         for r in records])
    results.update({
        "transport": rank0["transport"],
        "ranks": [{k: r.get(k) for k in (
            "rank", "chunk", "micro_step_ms", "micro_step_ms_all",
            "optimizer_step_ms", "collectives_ms_per_micro_step",
            "collective_bytes_per_micro_step", "whole_steps", "cli_train_s",
            "cli_train_peak_bytes",
            "train_step_peak_bytes", "card_used_bytes", "launches")}
                  for r in records],
        "whole_step_ms": whole_usp,
        "tokens_per_s": tokens / (whole_usp / 1e3),
        "single_process": {
            **{k: v for k, v in single_results.items()
               if k != "profile_micro_step"},
            "profile_micro_step": single_results.get("profile_micro_step"),
            "whole_step_ms": statistics.median(whole),
            "tokens_per_s": tokens / (statistics.median(whole) / 1e3),
        },
        "optimizer_steps": len(steps),
        "micro_batches": micro_batches,
        "accumulation_steps": accum, "files": files,
        "resume": {"from": "usp-step1", "steps": rank0["resumed_steps"],
                   "bit_exact": True} if resume else None,
        "ranks_bit_identical": True,
    })
    counts = {name: sum(r["launches"][name] for r in records)
              for name in LSE_KERNELS}
    results["rank_launches"] = [r["launches"] for r in records]
    return results, counts


# --------------------------------------------------------------------------
# slice 14: data parallelism and fsdp (and with USP) on 4 ranks
# --------------------------------------------------------------------------

MESH_RANKS = 4
MESH_TIMEOUT = 900  # seconds for the 4 ranks
#: name → (draft config, example run, layout, global batch, accumulation,
#: files, shortest and longest sample): EAGLE3 at dp 2 × fsdp 2 for 4 steps
#: (a 4-rank resume from the middle checkpoint, eval), P-EAGLE at fsdp 4,
#: Domino at dp 2 × fsdp 2 and EAGLE3 under USP at fsdp 2 × sp_ring 2 for a
#: step each
MESH_RUNS = {
    "eagle3": (CONFIG, EXAMPLE, {"dp_size": 2, "fsdp_size": 2}, 4, ACCUM, 32,
               1536, MAX_LEN),
    "peagle": (PEAGLE_CONFIG, PEAGLE_EXAMPLE, {"fsdp_size": 4}, 4, 1, 4, 768,
               1024),
    "domino": (DOMINO_CONFIG, DOMINO_EXAMPLE, {"dp_size": 2, "fsdp_size": 2},
               4, 1, 4, 512, 768),
    "usp": (CONFIG, USP_EXAMPLE, {"fsdp_size": 2, "sp_ulysses_size": 1,
                                  "sp_ring_size": 2}, 2, 1, 2, 3584,
            USP_MAX_LEN),
}
MESH_EVAL_FILES = 4
#: the drafts' layers and the EAGLE3 runs' tokens when the 4 ranks share
#: one card (each rank holds the frozen target tables, the gathered weights
#: and a window's whole fp32 gradients): Domino at 5 layers and the USP run
#: at 4096 tokens ran out of the card's 80 GB (18.8 and 18.6 GB allocated a
#: rank; the USP run fit at 2048), EAGLE3 at 2048 tokens filled it (19.0 GB
#: a rank) and ran out in a later run
MESH_ONE_CARD_LAYERS = {"domino": 2, "peagle": 2}
MESH_ONE_CARD_MAX_LEN = {"eagle3": 1024}
#: and, since a step over host-staged gloo takes 10-13 s and a checkpoint's
#: gather about as long while the whole script must end within its 1,200
#: s: EAGLE3's steps there take one micro-batch each over 8 files (2 steps
#: instead of 4, a resume from step 1), no rank times a micro-step
#: alone, and the USP run (fsdp 2 × sp_ring 2; 50-70 s there) is left to
#: the 4-card run, the USP phase driving USP on 4 ranks of the one card
MESH_ONE_CARD_FILES = {"eagle3": 8}
MESH_ONE_CARD_ACCUM = {"eagle3": 1}
MESH_ONE_CARD_SKIP = ("usp",)
#: and, since the serving phase joined the script, EAGLE3 there takes no
#: middle checkpoint (a whole-state gather and write), and its 4-rank
#: resume restores the end checkpoint and trains no step (no gloo step, no
#: second save); the 4-card run resumes from the middle checkpoint
MESH_COUNTERS = {**USP_COUNTERS, **DFLASH_COUNTERS, **PEAGLE_COUNTERS}


def mesh_run_json(workdir: Path, name: str, target: Path, cfg: Path,
                  max_length: int, files: int, accum: int,
                  mesh: bool, middle_checkpoint: bool = True) -> Path:
    """The example run of ``MESH_RUNS[name]``, read as data, pointed at this
    run's directories and draft config ``cfg``, at its global batch,
    accumulation ``accum``, ``max_length`` tokens, one epoch over ``files``
    files and a log line per step (EAGLE3 checkpoints halfway, with
    ``middle_checkpoint``, and at the end); on its layout (``mesh``), or in one
    process on the TTT kernels."""
    example, layout, batch = MESH_RUNS[name][1:4]
    raw = json.loads(example.read_text())
    run_id = f"{'mesh' if mesh else 'single'}_{name}"
    raw["run_id"] = run_id
    raw["output_dir"] = str(workdir / f"runs_{run_id}")
    raw["model"].update(target_model_path=str(target),
                        draft_config_path=str(cfg))
    raw["data"].update(train_data_path=str(workdir / name),
                       eval_data_path=(str(workdir / f"{name}_eval")
                                       if name == "eagle3" else None),
                       max_length=max_length, num_workers=2)
    raw["training"].update(batch_size=batch, accumulation_steps=accum,
                           num_epochs=1, log_interval=1, eval_interval=0,
                           save_interval=(files // (batch * accum) // 2
                                          if name == "eagle3"
                                          and middle_checkpoint
                                          else 0))
    if name == "peagle":
        raw["training"]["row_sparse_embedding"] = True
    if mesh:
        raw["training"].update(layout)
    else:
        # the mapping the mesh run derived from the same files
        raw["model"]["vocab_mapping_path"] = str(
            workdir / f"runs_mesh_{name}" / f"mesh_{name}.vocab_mapping.npz")
        raw["training"].update(dp_size=1, fsdp_size=1, sp_ulysses_size=1,
                               sp_ring_size=1)
        if name == "usp":
            raw["training"]["attention_backend"] = "pallas"
    raw["tracking"] = {"backend": "jsonl"}
    path = workdir / f"{run_id}.json"
    path.write_text(json.dumps(raw, indent=2))
    return path


def whole_weights_digest(trainer) -> str:
    """sha256 over every trainable tensor, whole (gathered from its fsdp
    shards; every rank takes part), in name order."""
    shards = trainer.shards
    h = hashlib.sha256()
    for name in sorted(trainer.state.params):
        p = trainer.state.params[name]
        dim = shards.dim(name) if shards is not None else None
        whole = p if dim is None else shards.gather(p, dim)
        h.update(name.encode())
        h.update(whole.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_micro_step(trainer, tensors, sync) -> dict:
    """One micro-step alone (forward and backward, the weights' gathers),
    its collectives timed on their own (``usp.TIMED``)."""
    from specforge_tpu_torch.parallel import usp

    sync()
    usp.reset_collective_stats()
    usp.TIMED = True
    try:
        t0 = time.perf_counter()
        trainer.train_step.micro_step(trainer.state, tensors, trainer.frozen)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        usp.TIMED = False
    return {"micro_step_ms": ms,
            "collectives_ms_per_micro_step": usp.COLLECTIVES["seconds"] * 1e3,
            "collective_bytes_per_micro_step": usp.COLLECTIVES["bytes"]}


def mesh_rank(workdir: Path, device, overrides=()) -> None:
    """One rank of the mesh phase (``chip_smoke.py --mesh-rank WORKDIR``,
    started 4 times with the SPECFORGE_* env): for each run of
    ``mesh_runs.json``, ``cli.main(["train", ...])`` with its launch counts
    set to 0 just before and read just after, its whole weights' digest,
    the bytes of this rank's masters and optimizer state, its timings and
    memory; for EAGLE3 also step 1's gradients from the same initial
    weights (gathered whole; rank 0 saves them) and a 4-rank resume from
    its middle checkpoint (from its end checkpoint, no step trained, where
    the ranks share one card). Everything into ``rank{N}.json``."""
    from specforge_tpu_torch.application import composition
    from specforge_tpu_torch.parallel import usp
    from specforge_tpu_torch.parallel.multihost import (
        barrier,
        maybe_initialize_distributed,
        process_index,
        shutdown,
    )

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    device = maybe_initialize_distributed(device)
    rank = process_index()
    overrides = list(overrides)
    device_args = [] if on_card else ["--device", str(device)]
    build = composition.build_training_run

    def trainer_for(name, *extra):
        config = load_config(str(workdir / f"mesh_{name}.json"),
                             overrides + list(extra))
        return build_training_run(config, device=None if on_card else device)

    out = {"rank": rank}
    try:
        for name in json.loads((workdir / "mesh_runs.json").read_text()):
            built = []

            def capture(*args, **kwargs):
                trainer = build(*args, **kwargs)
                step, losses, steps = trainer.train_step, [], []

                def recorded(state, batch, frozen):
                    # each whole step timed to the loss on the host: the
                    # gathers, the micro-steps, the window's reduce-scatters
                    # and all-reduces, the update
                    sync()
                    usp.reset_collective_stats()
                    t0 = time.perf_counter()
                    state, metrics = step(state, batch, frozen)
                    losses.append(float(metrics["train/loss"]))
                    steps.append({
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "collectives_ms": usp.COLLECTIVES["seconds"] * 1e3,
                        "collective_bytes": usp.COLLECTIVES["bytes"]})
                    return state, metrics

                recorded.__dict__.update(step.__dict__)
                trainer.train_step, trainer.losses = recorded, losses
                trainer.step_times = steps
                built.append(trainer)
                return trainer

            composition.build_training_run = capture
            for fn in MESH_COUNTERS.values():
                fn.launches = 0
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            sync()
            t0 = time.perf_counter()
            rc = cli.main(["train", "-c", str(workdir / f"mesh_{name}.json"),
                           *device_args,
                           *[a for o in overrides for a in ("--set", o)]])
            sync()
            rec = {"cli_train_s": time.perf_counter() - t0,
                   "launches": {n: fn.launches
                                for n, fn in MESH_COUNTERS.items()}}
            composition.build_training_run = build
            if rc != 0:
                raise AssertionError(f"rank {rank}: cli train of {name} "
                                     f"exited {rc}")
            trainer = built.pop()
            rec.update(
                transport=trainer.mesh.transport,
                coords=trainer.mesh.config.coords(rank),
                batch_block=trainer.mesh.batch_block,
                writes_checkpoints=trainer.checkpoints.primary,
                tracks=type(trainer.tracker).__name__ != "NoOpTracker",
                losses=list(trainer.losses), steps=trainer.state.step,
                whole_steps=list(trainer.step_times),
                digest=whole_weights_digest(trainer),
                state_bytes=state_bytes(trainer.state),
                sharded=sorted(n for n, d in trainer.shards.dims.items()
                               if d is not None))
            if on_card:
                rec["cli_train_peak_bytes"] = torch.cuda.max_memory_allocated()
            window = first_window(trainer)
            shared = share_one_card(device, MESH_RANKS)
            if name == "eagle3":
                steps = trainer.state.step
                rec["resumed_from"] = (
                    f"mesh_eagle3-step{steps if shared else steps // 2}")
                del trainer
                gc.collect()
                if on_card:
                    torch.cuda.empty_cache()
                # a fresh trainer: the initial weights until a resume's
                # fit restores the checkpoint
                trainer = trainer_for(
                    name, 'run_id="mesh_resumed"', "training.save_interval=0",
                    f'output_dir="{workdir / "runs_mesh_resumed"}"',
                    "data.eval_data_path=null",
                    "training.resume_from="
                    f"{workdir / 'runs_mesh_eagle3' / rec['resumed_from']}")
            if not shared:
                rec.update(mesh_micro_step(trainer, window[0], sync))
            if name == "eagle3":
                # step 1 from the same initial weights, before the resume
                if on_card:
                    torch.cuda.reset_peak_memory_stats()
                grads, stats = trainer.train_step.accumulate(
                    trainer.state, stack_window(window), trainer.frozen)
                if on_card:
                    rec["train_step_peak_bytes"] = (
                        torch.cuda.max_memory_allocated())
                rec["step1_loss"] = float(stats["loss"] / stats["norm"])
                shards = trainer.shards
                whole = {n: (g if shards.dim(n) is None
                             else shards.gather(g, shards.dim(n))).cpu()
                         for n, g in grads.items()}
                if rank == 0:
                    torch.save(whole, workdir / "mesh_step1_grads.pt")
                del whole, grads, stats
                sync()
                t0 = time.perf_counter()
                trainer.fit()
                sync()
                rec["resume_s"] = time.perf_counter() - t0
                rec["resumed_digest"] = whole_weights_digest(trainer)
                rec["resumed_steps"] = trainer.state.step
            barrier(f"mesh-{name}-memory")  # every rank holds its state
            if on_card:
                free, total = torch.cuda.mem_get_info()
                rec["card_used_bytes"] = total - free
            del trainer, window
            gc.collect()  # the recording wrapper makes a reference cycle
            if on_card:
                torch.cuda.empty_cache()
            barrier(f"mesh-{name}-done")
            out[name] = rec
            print(json.dumps({"mesh_run": name, "rank": rank, **{
                k: rec.get(k) for k in ("cli_train_s", "micro_step_ms",
                                        "whole_steps", "cli_train_peak_bytes",
                                        "card_used_bytes")}}), flush=True)
        (workdir / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        composition.build_training_run = build
        shutdown()


def mesh_expected_launches(name: str, micro: int, evals: int,
                           layers: int) -> dict:
    """Launches each kernel makes on one rank of a run: per micro-batch TTT
    of each EAGLE3 kernel (and of the forwards per eval forward), a DFlash
    kernel per layer (Domino), a COD kernel per layer and a fused CE kernel
    (P-EAGLE), TTT·sp_ring of each LSE kernel and TTT of each fused CE
    kernel (USP); none of the others."""
    out = dict.fromkeys(MESH_COUNTERS, 0)
    if name == "eagle3":
        for k in KERNEL_COUNTERS:
            out[k] = TTT * (micro + (0 if k in BACKWARD_KERNELS else evals))
    elif name == "usp":
        ring = MESH_RUNS[name][2]["sp_ring_size"]
        for k in LSE_KERNELS:
            out[k] = TTT * ring * micro
        out["fused_ce_fwd"] = out["fused_ce_bwd"] = TTT * micro
    elif name == "domino":
        for k in DFLASH_COUNTERS:
            out[k] = layers * micro
    else:
        for k in PEAGLE_COUNTERS:
            out[k] = (1 if k.startswith("fused_ce") else layers) * micro
    return out


def run_mesh_training(device, seed: int, workdir: Path, *, head_std=0.02,
                      overrides=()) -> tuple:
    """Slice 14 end to end → (results by run, the launch counts of each
    run's main path summed over the ranks).

    The main path is ``cli.main(["train", ...])`` on 4 ranks
    (``start_ranks``; over host-staged gloo when they share one card, NCCL
    with a card each) for each run of ``MESH_RUNS``, in one launch. The
    ranks must report the same per-step losses and bit-identical whole
    weights, only rank 0 may write, and the EAGLE3 resume from its middle
    checkpoint (its end checkpoint where the ranks share one card) must
    reach the final weights bit-exactly (``check_mesh_counts`` holds each
    rank's launches to ``mesh_expected_launches``). Then one process runs each
    run's global batch from the same initial weights on the TTT kernels:
    its per-step losses (and EAGLE3's step-1 gradients) against the
    mesh's, its state's bytes beside a rank's, and its whole-step time."""
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    eagle_cfg = Eagle3Config.from_file(MESH_RUNS["eagle3"][0])
    target = write_target_dir(workdir / "target", eagle_cfg.vocab_size,
                              eagle_cfg.resolved_target_hidden_size, device,
                              seed, head_std)
    # the ranks share the one card when there are fewer cards than ranks
    shared = share_one_card(device, MESH_RANKS)
    runs = [n for n in MESH_RUNS if not (shared and n in MESH_ONE_CARD_SKIP)]
    layers, max_len, n_files, accums = {}, {}, {}, {}
    for name in runs:
        cfg_path, *_, accum, files, lo, hi = MESH_RUNS[name]
        if shared:
            files = MESH_ONE_CARD_FILES.get(name, files)
            accum = MESH_ONE_CARD_ACCUM.get(name, accum)
        n_files[name], accums[name] = files, accum
        if shared and name in MESH_ONE_CARD_MAX_LEN:
            hi = MESH_ONE_CARD_MAX_LEN[name]
            lo = min(lo, hi - hi // 4)
        max_len[name] = hi
        draft = json.loads(cfg_path.read_text())
        layers[name] = draft.get("num_hidden_layers", 1)
        if shared and name in MESH_ONE_CARD_LAYERS:
            layers[name] = MESH_ONE_CARD_LAYERS[name]
            draft["num_hidden_layers"] = layers[name]
            if "layer_types" in draft:
                draft["layer_types"] = draft["layer_types"][:layers[name]]
            cfg_path = workdir / f"{name}_draft.json"
            cfg_path.write_text(json.dumps(draft, indent=2))
        if name == "domino":
            dcfg = DFlashConfig.from_dict(json.loads(cfg_path.read_text()))
            write_dflash_features(workdir / name,
                                  len(dcfg.resolved_target_layer_ids),
                                  dcfg.hidden_size, dcfg.vocab_size, seed,
                                  files, lo, hi)
        else:
            write_features(workdir / name, eagle_cfg, seed, files, lo, hi)
        mesh_run_json(workdir, name, target, cfg_path, hi, files, accum,
                      mesh=True, middle_checkpoint=not shared)
        mesh_run_json(workdir, name, target, cfg_path, hi, files, accum,
                      mesh=False, middle_checkpoint=not shared)
    write_features(workdir / "eagle3_eval", eagle_cfg, seed + 100,
                   MESH_EVAL_FILES, max_len["eagle3"] - max_len["eagle3"] // 4,
                   max_len["eagle3"])
    (workdir / "mesh_runs.json").write_text(json.dumps(runs))
    overrides = list(overrides)
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    records = start_ranks(workdir, device, overrides, "--mesh-rank",
                          MESH_RANKS, MESH_TIMEOUT, "mesh")
    results = {"ranks_s": time.perf_counter() - t0, "runs": {}}
    counts = {}
    for name in runs:
        layout, batch = MESH_RUNS[name][2:4]
        hi, files, accum = max_len[name], n_files[name], accums[name]
        recs = [r[name] for r in records]
        rank0 = recs[0]
        steps = step_records(workdir / f"runs_mesh_{name}", f"mesh_{name}")
        micro = len(steps) * accum
        evals = MESH_EVAL_FILES // batch if name == "eagle3" else 0
        for r, rec in enumerate(recs):
            if rec["losses"] != rank0["losses"]:
                raise AssertionError(f"{name} rank {r}: per-step losses "
                                     "differ from rank 0's")
            if rec["digest"] != rank0["digest"]:
                raise AssertionError(f"{name} rank {r}: whole weights "
                                     "differ from rank 0's")
            if name == "eagle3" and (rec["resumed_digest"] != rank0["digest"]
                                     or rec["step1_loss"]
                                     != rank0["step1_loss"]):
                raise AssertionError(f"{name} rank {r}: the resume from "
                                     f"{rec['resumed_from']} did not reach "
                                     "the final weights bit-exactly, or step "
                                     "1 differs")
        roles = [(r["writes_checkpoints"], r["tracks"]) for r in recs]
        if roles != [(True, True)] + [(False, False)] * (MESH_RANKS - 1):
            raise AssertionError(f"{name}: IO roles {roles}")
        if [s["train/loss"] for s in steps] != rank0["losses"]:
            raise AssertionError(f"{name}: rank 0's tracker disagrees")
        counts[name] = {k: sum(r["launches"][k] for r in recs)
                        for k in MESH_COUNTERS}
        res = {"layout": layout, "global_batch": batch,
               "layers": layers[name],
               "accumulation_steps": accum, "files": files,
               "max_length": hi, "optimizer_steps": len(steps),
               "transport": rank0["transport"],
               "sharded_tensors": len(rank0["sharded"]),
               "micro_batches": micro, "eval_forwards": evals,
               "rank_launches": [rec["launches"] for rec in recs],
               "ranks": [{k: rec.get(k) for k in (
                   "coords", "batch_block", "micro_step_ms",
                   "collectives_ms_per_micro_step",
                   "collective_bytes_per_micro_step", "whole_steps",
                   "cli_train_s", "cli_train_peak_bytes",
                   "train_step_peak_bytes", "card_used_bytes",
                   "state_bytes")} for rec in recs],
               "ranks_bit_identical": True}

        # one process, the same global batch and initial weights
        single = build_training_run(
            load_config(str(workdir / f"single_{name}.json"), overrides),
            device=None if on_card else device)
        window = first_window(single)
        if name == "eagle3":
            loss_s, grads_s = window_grads(single, window)
            check("step-1 loss, mesh vs one process",
                  abs(rank0["step1_loss"] - loss_s) / abs(loss_s),
                  TRAIN_STEP1_RTOL)
            grads_m = torch.load(workdir / "mesh_step1_grads.pt",
                                 weights_only=True)
            res["step1_grads"] = compare_grads(
                grads_m, {k: g.cpu() for k, g in grads_s.items()})
            del grads_s, grads_m
            res["resume"] = {"from": rank0["resumed_from"],
                             "steps": rank0["resumed_steps"],
                             "bit_exact": True,
                             "seconds": [rec["resume_s"] for rec in recs]}
            res["final_eval"] = final_eval(CheckpointManager.resolve_step_dir(
                str(workdir / "runs_mesh_eagle3")))
            if not all(math.isfinite(v) for v in res["final_eval"].values()):
                raise AssertionError(f"eval not finite: {res['final_eval']}")
        single_steps = train_windows(single)
        curve = []
        for k, p in zip(steps, single_steps, strict=True):
            rel = abs(k["train/loss"] - p["train/loss"]) / abs(p["train/loss"])
            if not (math.isfinite(k["train/loss"])
                    and math.isfinite(p["train/loss"])):
                raise AssertionError(f"{name} step {k['step']}: loss not "
                                     "finite")
            check(f"{name} step {k['step']} train/loss, mesh vs one process",
                  rel, TRAIN_STEP1_RTOL if k["step"] == 1 else
                  TRAIN_DRIFT_RTOL)
            curve.append({"step": k["step"], "loss": k["train/loss"],
                          "single_loss": p["train/loss"], "rel_diff": rel,
                          "grad_norm": k["train/grad_norm"],
                          "single_grad_norm": p["train/grad_norm"]})
        res["loss_curve"] = curve
        one = state_bytes(single.state)
        whole = []
        for _ in range(2 if name == "eagle3" else 1):
            sync()
            t0 = time.perf_counter()
            single.state, _ = single.train_step(
                single.state, stack_window(window), single.frozen)
            sync()
            whole.append((time.perf_counter() - t0) * 1e3)
        del single, window
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        tokens = batch * accum * hi  # the global batch's padded positions
        # a rank's whole steps after the first (its warm-up), when it has
        whole_mesh = statistics.median(statistics.median(
            w["ms"] for w in r["whole_steps"][1:] or r["whole_steps"])
            for r in recs)
        fsdp = layout.get("fsdp_size", 1)
        res.update({
            "single_process": {"state_bytes": one, "whole_step_ms_all": whole,
                               "whole_step_ms": statistics.median(whole),
                               "tokens_per_s": tokens / (
                                   statistics.median(whole) / 1e3)},
            "whole_step_ms": whole_mesh,
            "tokens_per_s": tokens / (whole_mesh / 1e3),
            # a rank's state against one process's: about 1/fsdp
            "state_bytes_ratio": {
                k: rank0["state_bytes"][k] / one[k] for k in one if one[k]},
            "fsdp": fsdp,
        })
        for k, ratio in res["state_bytes_ratio"].items():
            if fsdp > 1 and not ratio < 1.0:
                raise AssertionError(f"{name}: a rank holds {ratio} of the "
                                     f"one process's {k} bytes")
        results["runs"][name] = res
        shutil.rmtree(workdir / f"runs_single_{name}", ignore_errors=True)
    return results, counts


def check_peagle_counts(counts: dict, micro_batches: int, layers: int) -> None:
    """Exactly one launch of each COD kernel per layer and micro-batch, and
    one of each fused CE kernel per micro-batch."""
    for name, n in counts.items():
        per = 1 if name.startswith("fused_ce") else layers
        if n != per * micro_batches:
            raise AssertionError(
                f"{name}: {n} launches, expected {per * micro_batches} "
                f"({per} per micro-batch)")


def check_family_counts(counts: dict, micro_batches: int, layers: int) -> None:
    """Exactly one launch of each DFlash kernel per layer and micro-batch."""
    for name, n in counts.items():
        if n != layers * micro_batches:
            raise AssertionError(
                f"{name}: {n} launches, expected {layers * micro_batches} "
                f"({layers} per micro-batch)")


def final_eval(step_dir) -> dict:
    """The eval metrics saved beside a checkpoint."""
    meta = json.loads((Path(step_dir) / "contract.json").read_text())
    return {k: v for k, v in meta["metrics"].items() if k.startswith("eval/")}


def check_training_counts(counts: dict, micro_batches: int,
                          eval_forwards: int) -> None:
    """Exactly TTT launches of every kernel per micro-batch, and of the
    forward kernels per eval forward."""
    for name, n in counts.items():
        backward = name in BACKWARD_KERNELS
        forwards = micro_batches + (0 if backward else eval_forwards)
        per = "micro-batch" if backward else "forward"
        if n != TTT * forwards:
            raise AssertionError(
                f"{name}: {n} launches in the training run, expected "
                f"{TTT * forwards} ({TTT} per {per})")


def check_mesh_counts(results: dict) -> None:
    """Every rank of every run launched each kernel as
    ``mesh_expected_launches`` says."""
    for name, res in results["runs"].items():
        expected = mesh_expected_launches(name, res["micro_batches"],
                                          res["eval_forwards"], res["layers"])
        for rank, launches in enumerate(res["rank_launches"]):
            for kernel, n in launches.items():
                if n != expected[kernel]:
                    raise AssertionError(
                        f"{name} rank {rank}: {kernel} launched {n} times, "
                        f"expected {expected[kernel]}")


def mesh_phase(seed: int) -> None:
    """Phase 9's training (``run_mesh_training`` on the card) and its
    line."""
    with tempfile.TemporaryDirectory() as tmp:
        results, counts = run_mesh_training(torch.device("cuda"), seed,
                                            Path(tmp))
    check_mesh_counts(results)
    shared = next(iter(results["runs"].values()))["transport"] == "gloo"
    eagle3 = results["runs"]["eagle3"]
    emit({"phase": "mesh_training",
          "ranks": MESH_RANKS,
          "configs": {name: {"draft_config": str(run[0].relative_to(REPO)),
                             "run": str(run[1].relative_to(REPO))}
                      for name, run in MESH_RUNS.items()},
          "cards": "the 4 ranks share one card" if shared else
                   "4 cards, one a rank",
          "reduced": {
              "eagle3": (f"{eagle3['optimizer_steps']} optimizer steps of "
                         f"{eagle3['accumulation_steps']} micro-batches of the "
                         f"global batch {eagle3['global_batch']}, "
                         f"{eagle3['files']} files, checkpoints at steps "
                         + ("" if shared else
                            f"{eagle3['optimizer_steps'] // 2} and ")
                         + f"{eagle3['optimizer_steps']}, resumed from "
                         + eagle3["resume"]["from"]),
              "peagle": "one step of the global batch 4, 4 files of "
                        "768-1024 tokens, row-sparse embedding",
              "domino": "one step of the global batch 4, 4 files of "
                        "512-768 tokens",
              "usp": "one step of the global batch 2"
                     if "usp" in results["runs"] else
                     "not run: the ranks share one card (the USP phase "
                     "drives USP on 4 ranks there)",
              "one_card": {"layers": MESH_ONE_CARD_LAYERS,
                           "max_length": MESH_ONE_CARD_MAX_LEN,
                           "files": MESH_ONE_CARD_FILES,
                           "accumulation_steps": MESH_ONE_CARD_ACCUM,
                           "skipped": list(MESH_ONE_CARD_SKIP),
                           "micro_step_timed": False,
                           "eagle3_resume": "from the end checkpoint, "
                                            "no step trained",
                           "why": "the 4 ranks share the card's 80 GB "
                                  "(layers, tokens) and its time (files, "
                                  "accumulation, the USP run, the "
                                  "micro-step's timing, the EAGLE3 "
                                  "middle checkpoint and resumed steps)"}
              if shared else None},
          "launches_summed_over_ranks": counts,
          "tolerances": {"step1_loss_rtol": TRAIN_STEP1_RTOL,
                         "later_loss_rtol": TRAIN_DRIFT_RTOL,
                         "grad_cosine": GRAD_COSINE,
                         "grad_norm_rtol": GRAD_NORM_RTOL},
          **results})
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# slice 15: the offline leftovers — every RoPE type, reference features and
# warm start — on the Llama-3-70B, Qwen2.5-VL-7B and DeepSeek-V2-Lite drafts
# --------------------------------------------------------------------------

LLAMA_CONFIG = REPO / "configs" / "llama3-70b-eagle3.json"
QWEN_VL_CONFIG = REPO / "configs" / "qwen2.5-vl-7b-eagle3.json"
DEEPSEEK_CONFIG = REPO / "configs" / "deepseek-v2-lite-eagle3.json"
#: run name → its draft config and how the phase drives it: feature files,
#: accumulation (so optimizer steps = files / (BATCH · accum)), the feature
#: format (reference ``.ckpt``, ``.sft`` with mrope's [3, S] position ids,
#: or those ``moe_capture_phase`` captures from the DeepSeek-V2-Lite-shaped
#: target), a warm start from an export written here, and the timings (the
#: micro-step, optimizer step, peak memory, a profiled micro-step)
LEFTOVER_RUNS = {
    "llama3_70b": dict(config=LLAMA_CONFIG, files=TRAIN_FILES, accum=ACCUM,
                       features="ckpt", warm_start=True, timed=True),
    "qwen2_5_vl_7b": dict(config=QWEN_VL_CONFIG, files=BATCH, accum=1,
                          features="mrope", warm_start=False, timed=False),
    "deepseek_v2_lite": dict(config=DEEPSEEK_CONFIG, files=CAPTURE_BATCH,
                             accum=ACCUM, features="captured",
                             warm_start=False, timed=False),
}
def write_warm_start_export(root: Path, cfg_path: Path, device, seed: int
                            ) -> dict:
    """A trained draft's ``model.safetensors`` in the SGLang export layout
    (the exporter's ``serving_state``: bf16, ``q_proj``/``k_proj``/
    ``v_proj`` and ``gate_proj``/``up_proj`` split out of the merged
    projections; no embedding, a vocab map), made from a seeded draft and
    written by the port's writer, with no checkpoint in between → the
    values the port's parameters must take, by port name (bf16, on the
    host)."""
    cfg = Eagle3Config.from_file(cfg_path)
    draft = LlamaEagle3Draft(cfg, device=device, seed=seed + 7)
    draft.set_vocab_maps(*vocab_map(cfg, seed + 7))
    params = {name: p.detach() for name, p in draft.named_parameters()
              if name != "embed_tokens.weight"}
    expected = {name: p.to(torch.bfloat16).cpu()
                for name, p in params.items()}
    tensors = serving_state(params, {"t2d": draft.t2d, "d2t": draft.d2t},
                            device=device)
    del draft, params
    root.mkdir(parents=True, exist_ok=True)
    save_feature_file(str(root / "model.safetensors"), tensors)
    return expected


def leftover_run_json(workdir: Path, cfg_path: Path, target: Path,
                      max_length: int, accum: int,
                      warm_start: Optional[Path]) -> Path:
    """``examples/qwen3-8b-eagle3-offline.json``, read as data, pointed at
    this run's draft config, features and target, one epoch with no eval
    and no checkpoint but the epoch's last, and the warm start when
    given."""
    raw = json.loads(EXAMPLE.read_text())
    raw["run_id"] = "smoke"
    raw["output_dir"] = str(workdir / "runs")
    raw["model"].update(target_model_path=str(target),
                        draft_config_path=str(cfg_path))
    if warm_start is not None:
        raw["model"]["draft_checkpoint_path"] = str(warm_start)
    raw["data"].update(train_data_path=str(workdir / "train"),
                       eval_data_path=None, max_length=max_length,
                       num_workers=2)
    raw["training"].update(num_epochs=1, accumulation_steps=accum,
                           save_interval=0, eval_interval=0, log_interval=1)
    raw["tracking"] = {"backend": "jsonl"}
    path = workdir / "run.json"
    path.write_text(json.dumps(raw, indent=2))
    return path


def run_leftover(spec: dict, device, seed: int, workdir: Path, *,
                 max_length=MAX_LEN, min_len=1536, head_std=0.02,
                 overrides=(), captured: Optional[dict] = None) -> tuple:
    """One draft of ``LEFTOVER_RUNS`` through ``cli train`` (the counted main
    path), then its kernel-path trainer (the warm-started weights against
    the export's, the step-1 loss and gradients twice for the same bits and
    against the ``cli`` run's step 1; the timings) and its plain-path
    trainer (chunked attention, reference CE) from the same weights →
    (results, launch counts). ``captured``: what ``capture_phase`` captured
    into ``workdir`` (its target, whose head and embedding the trainers
    read, and its vocab mapping), in place of random features and a random
    head."""
    t_start = time.perf_counter()
    cfg_path = spec["config"]
    cfg = Eagle3Config.from_file(cfg_path)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    overrides = list(overrides)
    if captured is not None:
        target = captured["target"]
        overrides.append(
            f'model.vocab_mapping_path="{captured["vocab_mapping"]}"')
    else:
        write_features(workdir / "train", cfg, seed, spec["files"], min_len,
                       max_length, fmt=spec["features"])
        target = write_target_dir(workdir / "target", cfg.vocab_size,
                                  cfg.resolved_target_hidden_size, device,
                                  seed, head_std)
    warm_dir = workdir / "export" if spec["warm_start"] else None
    expected = (write_warm_start_export(warm_dir, cfg_path, device, seed)
                if warm_dir is not None else None)
    run_json = leftover_run_json(workdir, cfg_path, target, max_length,
                                 spec["accum"], warm_dir)
    runs = workdir / "runs"
    device_args = [] if on_card else ["--device", str(device)]
    results = {"setup_s": time.perf_counter() - t_start,
               "feature_files": sorted(p.name for p in
                                       (workdir / "train").iterdir())}

    def trainer_for(*extra):
        config = load_config(str(run_json), overrides + list(extra))
        return build_training_run(config, device=None if on_card else device)

    # the main path: cli train
    for fn in KERNEL_COUNTERS.values():
        fn.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    rc = cli.main(["train", "-c", str(run_json), *device_args,
                   *[a for o in overrides for a in ("--set", o)]])
    sync()
    results["cli_train_s"] = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in KERNEL_COUNTERS.items()}
    if rc != 0:
        raise AssertionError(f"cli train exited {rc}")
    if on_card:
        results["cli_train_peak_bytes"] = torch.cuda.max_memory_allocated()
    steps = step_records(runs, "smoke")
    micro_batches = spec["files"] // BATCH
    if len(steps) * spec["accum"] != micro_batches:
        raise AssertionError(f"{len(steps)} optimizer steps of "
                             f"{spec['accum']} micro-batches, expected "
                             f"{micro_batches} micro-batches")
    for k in steps:
        if not (math.isfinite(k["train/loss"])
                and math.isfinite(k["train/grad_norm"])):
            raise AssertionError(f"step {k['step']}: loss not finite")
    # the vocab mapping the cli run derived from the features: the trainers
    # below read it instead of deriving it again
    derived = runs / "smoke.vocab_mapping.npz"
    if derived.exists():
        mapping = workdir / "vocab_mapping.npz"
        shutil.move(derived, mapping)
        overrides.append(f'model.vocab_mapping_path="{mapping}"')
    shutil.rmtree(runs)

    # the kernel path: the same weights as the cli run's (warm-started, or
    # drawn from the same seed)
    kernel = trainer_for('run_id="kernel"')
    if expected is not None:
        mismatched = [n for n, v in expected.items() if not torch.equal(
            kernel.state.params[f"draft_model.{n}"].detach().cpu(),
            v.float())]
        check("warm-started weights differing from the export's",
              float(len(mismatched)), 0.0)
        results["warm_start"] = {"from": "model.safetensors (export layout)",
                                 "tensors": len(expected),
                                 "bit_identical": not mismatched}
    window = first_window(kernel)
    loss_k, grads_k = window_grads(kernel, window)
    loss_again, grads_again = window_grads(kernel, window)
    repeat = loss_again == loss_k and all(
        torch.equal(g, grads_again[n]) for n, g in grads_k.items())
    check("step-1 loss and gradients, repeated (bits differing)",
          0.0 if repeat else 1.0, 0.0)
    check("step-1 loss, kernel trainer vs the cli run (bits differing)",
          0.0 if loss_k == steps[0]["train/loss"] else 1.0, 0.0)
    results["repeat_bit_exact"] = repeat
    del grads_again
    grads_k = {k: g.cpu() for k, g in grads_k.items()}
    if spec["timed"]:
        results.update(measure_kernel_path(kernel, window, sync))
    del kernel
    if on_card:
        torch.cuda.empty_cache()

    # the plain path from the same weights: chunked attention (the dense
    # backend at S >= 1024) and the reference CE
    plain = trainer_for('run_id="plain"',
                        'training.attention_backend="dense"')
    plain.strategy.model.loss_fn = log_softmax_loss_reference
    loss_p, grads_p = window_grads(plain, window)
    del plain
    rel = abs(loss_k - loss_p) / abs(loss_p)
    check("step-1 loss, kernel vs plain", rel, TRAIN_STEP1_RTOL)
    results["step1"] = {"loss": loss_k, "plain_loss": loss_p,
                        "rel_diff": rel}
    grads = compare_grads(grads_k, grads_p)
    del grads_k, grads_p
    cosines = [g["cosine"] for g in grads.values() if g["cosine"] is not None]
    results["step1_grads"] = {
        "min_cosine": min(cosines),
        "max_norm_rel_diff": max(g["norm_rel_diff"] for g in grads.values()
                                 if g["cosine"] is not None),
        "parameters": len(grads)}
    if on_card:
        torch.cuda.empty_cache()
    results.update({
        "optimizer_steps": len(steps),
        "micro_batches": micro_batches,
        "loss_curve": [{"step": k["step"], "loss": k["train/loss"],
                        "grad_norm": k["train/grad_norm"]} for k in steps],
        "seconds": time.perf_counter() - t_start,
    })
    if "micro_step_ms" in results:
        results["tokens_per_s"] = BATCH * max_length / (
            results["micro_step_ms"] / 1e3)
    return results, counts


def emit_leftover(name: str, spec: dict, results: dict, counts: dict
                  ) -> None:
    check_training_counts(counts, results["micro_batches"], 0)
    draft = json.loads(spec["config"].read_text())
    emit({"phase": f"offline_leftovers_{name}",
          "config": str(EXAMPLE.relative_to(REPO)),
          "draft_config": str(spec["config"].relative_to(REPO)),
          "rope": draft.get("rope_scaling"),
          "heads": [draft["num_attention_heads"],
                    draft["num_key_value_heads"]],
          "features": spec["features"], "batch": BATCH,
          "max_length": MAX_LEN, "ttt_length": TTT,
          "accumulation_steps": spec["accum"], "launches": counts,
          "reduced": {"steps": f"{spec['files'] // BATCH // spec['accum']}"
                               " optimizer steps, no eval",
                      "weights": "random, from --seed"},
          "tolerances": {"step1_loss_rtol": TRAIN_STEP1_RTOL,
                         "grad_cosine": GRAD_COSINE,
                         "grad_norm_rtol": GRAD_NORM_RTOL},
          **results})


def moe_capture_phase(seed: int, depth: int,
                      mesh_refs: Optional[Path] = None) -> dict:
    """Slice 17 on the card: ``capture_phase`` from a random target in
    DeepSeek-V2-Lite's shape cut to ``depth`` layers (its line
    ``capture_moe``), then, given ``mesh_refs`` (the dense capture's
    target and reference), slice 20's ``capture_mesh_phase`` on both
    targets (its line ``capture_mesh``), then
    ``LEFTOVER_RUNS["deepseek_v2_lite"]``, its EAGLE3 draft, trained on the
    captured features and the target's head and embedding (its
    ``offline_leftovers`` line) → the training run's launch counts."""
    device = torch.device("cuda")
    spec = LEFTOVER_RUNS["deepseek_v2_lite"]
    full = DEEPSEEK_V2_LITE_TARGET["num_hidden_layers"]
    dense = DEEPSEEK_V2_LITE_TARGET["first_k_dense_replace"]
    with tempfile.TemporaryDirectory() as tmp:
        mesh = None
        if mesh_refs is not None:  # the ranks start while the MoE captures
            mesh = launch_capture_mesh(
                [{"name": "dense_fsdp",
                  "target": str(mesh_refs / "dense_target"),
                  "ref": str(mesh_refs / "dense_ref.pt")},
                 {"name": "moe_ep", "target": str(Path(tmp) / "target"),
                  "ref": str(Path(tmp) / "moe_ref.pt")}],
                Path(tmp) / "capture_mesh", device)
        try:
            results, captured = capture_phase(
                spec["config"], device, seed, Path(tmp),
                target_config=DEEPSEEK_V2_LITE_TARGET, depth=depth,
                n_train=spec["files"], n_eval=0,
                capture_layers=None if depth == full else MOE_CAPTURE_LAYERS,
                shard_layers=MOE_SHARD_LAYERS,
                ref_path=None if mesh is None else Path(tmp) / "moe_ref.pt")
        except BaseException:
            if mesh is not None:  # no rank waits for a reference in vain
                kill_ranks(mesh)
            raise
        emit({"phase": "capture_moe",
              "draft_config": str(spec["config"].relative_to(REPO)),
              "layout": "eagle", "template": "qwen",
              "reduced": {
                  "weights": f"random, from --seed (std {TARGET_STD})",
                  "depth": None if depth == full else
                  f"{depth} of {full} layers ({dense} dense, "
                  f"{depth - dense} MoE; the default run's 1,200 s; "
                  f"--capture-only runs all {full}), capture layers "
                  f"{list(MOE_CAPTURE_LAYERS)} by the run's override (the "
                  "EAGLE3 rule gives [1, 2, 2] at 6)",
                  "samples": f"{spec['files']} conversations of 1536-2048 "
                             "tokens, one padded batch"},
              "tolerances": {"rel_l2": CAPTURE_REL_L2,
                             "route_agreement": MOE_ROUTE_AGREEMENT,
                             "dense_vs_gathered": (
                                 f"each MoE layer alone: |d - g| <= "
                                 f"{MOE_IMPL_TOL} * (1 + |g|), the same "
                                 "routing")},
              **results})
        torch.cuda.empty_cache()
        if mesh is not None:
            results = finish_capture_mesh(mesh)
            shutil.rmtree(mesh_refs / "dense_target")
            emit_capture_mesh(results, {
                "weights": f"random, from --seed (std {TARGET_STD})",
                "targets": f"phase capture's ({CAPTURE_DEPTH} of 36 "
                           "Qwen3-8B layers) and capture_moe's "
                           f"({depth} of {full} DeepSeek-V2-Lite layers): "
                           "the default run's 1,200 s",
                "ranks": f"{CAPTURE_MESH_RANKS} sharing the card "
                         "(--capture-mesh-only: a rank per card)",
                "batch": "the first padded batch of each capture"})
            torch.cuda.empty_cache()
        results, counts = run_leftover(spec, device, seed, Path(tmp),
                                       captured=captured)
    emit_leftover("deepseek_v2_lite", spec, results, counts)
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# slice 20: the capture mesh and expert parallelism
# --------------------------------------------------------------------------

#: the default run's capture mesh: two ranks sharing the card over
#: host-staged gloo (``--capture-mesh-only`` takes a rank per card)
CAPTURE_MESH_RANKS = 2
#: seconds the ranks of one capture-mesh launch may take together
CAPTURE_MESH_TIMEOUT = 600
#: phase (c)'s factor that drops rows: every rank holds about 1/ep of the
#: real assignments, so 0.5·m/ep rows overflow (the runner must abort);
#: the factor that fits is the least one, to 0.05 up, that holds the
#: fullest rank's rows of the reference's routing (``fitting_factor``)
MOE_OVERFLOW_FACTOR = 0.5
#: Llama-3-70B's target (``configs/llama3-70b-eagle3.json``'s widths, its
#: rope; meta-llama/Llama-3.1-70B's config.json)
LLAMA3_70B_TARGET = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 8192, "intermediate_size": 28672,
    "num_hidden_layers": 80, "num_attention_heads": 64,
    "num_key_value_heads": 8, "head_dim": 128, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0, "max_position_embeddings": 131072,
    "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                     "high_freq_factor": 4.0, "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192},
    "hidden_act": "silu", "attention_bias": False,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16",
}
#: the 4-card run's Llama-3-70B depth: 48 of 80 layers are 86.3 GB in
#: bf16, more than one card holds (the case the mesh exists for); less
#: when the machine's disk cannot hold the files
LLAMA_MESH_DEPTH = 48
#: the layers the 4-card Llama run captures, all among the first
#: ``LLAMA_REF_DEPTH``, which one process captures too (bit for bit)
LLAMA_MESH_LAYERS = (1, 4, 7)
LLAMA_REF_DEPTH = 8


def save_capture_reference(runner, ids: np.ndarray, mask: np.ndarray,
                           path: Path) -> None:
    """What the capture-mesh ranks hold their run against, from a
    one-process ``gathered`` runner: the padded batch, its bf16 capture
    (aux, last), the bytes the process holds; for an MoE target also each
    MoE layer's bf16 routing, and the first MoE layer alone in fp32 (no
    TF32): its input (the residual stream before it) and its output."""
    tc = runner.target_config
    params = runner.params
    ids_t = torch.as_tensor(ids, device=runner.device)
    mask_t = torch.as_tensor(mask, device=runner.device)
    layers = tuple(runner.config.capture_layers)
    routes = {}
    aux, last = target_capture_forward(params, tc, ids_t, mask_t, layers,
                                       routing=routes)
    ref = {"ids": torch.as_tensor(ids), "mask": torch.as_tensor(mask),
           "layers": list(layers),
           "aux": aux.cpu(), "last": last.cpu(),
           "resident_bytes": sum(t.numel() * t.element_size()
                                 for t in params.values()),
           "routes": {k: v.cpu() for k, v in routes.items()}}
    del aux, last
    if tc.num_experts:
        i = next(j for j in range(tc.num_hidden_layers)
                 if tc.is_moe_layer(j))
        with fp32_matmuls():
            stream = target_capture_forward(
                params, dataclasses.replace(tc, num_hidden_layers=i), ids_t,
                mask_t, (i - 1,), compute_dtype=torch.float32)[0]
            layer_routes = {}
            out, _ = target_capture_forward(
                moe_layer_cut(params, i), moe_layer_config(tc), ids_t,
                mask_t, (0,), compute_dtype=torch.float32,
                inputs_embeds=stream, routing=layer_routes)
        ref.update(moe_layer=i, moe_in=stream.cpu(), moe_out=out.cpu(),
                   moe_routes=layer_routes[0].cpu())
        del stream, out
    # whole or absent: capture-mesh ranks may be waiting for it
    torch.save(ref, f"{path}.part")
    os.replace(f"{path}.part", path)


def moe_layer_config(tc: TargetConfig) -> TargetConfig:
    return dataclasses.replace(tc, num_hidden_layers=1,
                               first_k_dense_replace=0)


def moe_layer_cut(params, i: int) -> dict:
    """Decoder layer ``i`` of ``params`` (a mapping; sharded params' layer
    gathered) as the one layer of a target, with its embedding and norm."""
    layer = params.layer(i) if hasattr(params, "layer") else params
    prefix = f"model.layers.{i}."
    cut = {k.replace(prefix, "model.layers.0."): v for k, v in layer.items()
           if k.startswith(prefix)}
    cut["model.embed_tokens.weight"] = params["model.embed_tokens.weight"]
    cut["model.norm.weight"] = (params.whole("model.norm.weight")
                                if hasattr(params, "whole")
                                else params["model.norm.weight"])
    return cut


def tensor_digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def fitting_factor(top_i: torch.Tensor, valid: torch.Tensor, experts: int,
                   ep: int) -> float:
    """The least capacity factor, to 0.05 up, whose ``ceil(cf·m/ep)`` rows
    hold the fullest rank's assignments of the routing ``top_i`` [t, k]
    over the real tokens ``valid`` [t] (padding joins no group)."""
    sizes = torch.bincount(top_i[valid].reshape(-1), minlength=experts)
    fullest = int(sizes.view(ep, -1).sum(dim=1).max())
    return math.ceil(20 * fullest * ep / top_i.numel()) / 20


def host_copy_rates(nbytes: int, device, runs: int = 3) -> dict:
    """GB/s of a copy of ``nbytes`` between the card and the host, each
    way, from pageable and from page-locked host memory (what a staged
    collective moves; median of ``runs``)."""
    x = torch.empty(nbytes, dtype=torch.uint8, device=device)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(nbytes, dtype=torch.uint8)
    rates = {}
    for name, fn in (("d2h_pageable", lambda: pageable.copy_(x)),
                     ("d2h_pinned", lambda: pinned.copy_(x)),
                     ("h2d_pageable", lambda: x.copy_(pageable)),
                     ("h2d_pinned", lambda: x.copy_(pinned))):
        times = []
        for _ in range(runs):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            times.append(time.perf_counter() - t0)
        rates[name] = nbytes / statistics.median(times) / 1e9
    return rates


def capture_mesh_run(run: dict, mesh, device, workdir: Path) -> dict:
    """One run of a capture-mesh rank: the target of ``run`` loaded as this
    rank's shards (``moe_impl="ep"`` for an MoE target), the reference's
    padded batch captured (3 timed forwards, then one with the collectives
    timed), and its checks' numbers: a dense target's features against
    the one-process capture (bit for bit), an MoE target's relative L2
    error and routing agreement, its first MoE layer alone in fp32 at full
    capacity and at its fitting factor against the gathered layer, and the
    runner's abort at ``MOE_OVERFLOW_FACTOR``."""
    from specforge_tpu_torch.offline_capture.capture import CapacityOverflow
    from specforge_tpu_torch.parallel import usp

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    deadline = time.monotonic() + CAPTURE_MESH_TIMEOUT
    while not os.path.exists(run["ref"]):  # written while the ranks start
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference {run['ref']}")
        time.sleep(0.2)
    ref = torch.load(run["ref"])
    ids, mask = ref["ids"].numpy(), ref["mask"].numpy()
    layers = tuple(ref["layers"])
    batch, seq = ids.shape
    tc = TargetConfig.from_file(run["target"])
    moe = tc.num_experts > 0
    impl = "ep" if moe else "gathered"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    config = OfflineCaptureConfig(run["target"], str(workdir / "unused"),
                                  layers, seq, batch)
    runner = OfflineCaptureRunner(config, target_config=tc, mesh=mesh,
                                  moe_impl=impl, device=device)
    sync()
    params = runner.params
    out = {"load_s": time.perf_counter() - t0,
           "resident_bytes": params.resident_bytes(),
           "one_process_bytes": ref["resident_bytes"]}
    ids_t = torch.as_tensor(ids, device=device)
    mask_t = torch.as_tensor(mask, device=device)
    valid = torch.as_tensor(mask, dtype=torch.bool)

    def forward(routes=None, stats=None):
        return target_capture_forward(params, tc, ids_t, mask_t, layers,
                                      moe_impl=impl, mesh=mesh,
                                      routing=routes, stats=stats)

    # the first forward (the checks' features and the bytes gathered),
    # then one with the collectives timed (the card synced around each)
    before = dict(params.gathered)
    routes, stats = {}, {}
    sync()
    t0 = time.perf_counter()
    aux, last = forward(routes, stats)
    sync()
    out["first_forward_ms"] = (time.perf_counter() - t0) * 1e3
    out["gathered_bytes_per_forward"] = (params.gathered["bytes"]
                                         - before["bytes"])
    out["gathers_per_forward"] = params.gathered["calls"] - before["calls"]
    usp.reset_collective_stats()
    usp.TIMED = True
    try:
        sync()
        t0 = time.perf_counter()
        forward()
        sync()
        timed_s = time.perf_counter() - t0
    finally:
        usp.TIMED = False
    real = int(mask.sum())
    out["real_tokens"] = real
    out["forward_ms"] = timed_s * 1e3
    out["tokens_per_s"] = real / timed_s
    out["collectives"] = dict(usp.COLLECTIVES)
    out["collective_share"] = usp.COLLECTIVES["seconds"] / timed_s
    out["collective_ms_per_layer"] = (usp.COLLECTIVES["seconds"] * 1e3
                                      / tc.num_hidden_layers)
    aux, last = aux.cpu(), last.cpu()
    out["digest"] = tensor_digest(aux, last)
    if not moe:
        out["aux_bit_identical"] = torch.equal(aux, ref["aux"])
        if run.get("compare_last", True):
            out["last_bit_identical"] = torch.equal(last, ref["last"])
        if on_card:
            out["host_copy_GBps"] = host_copy_rates(
                out["gathered_bytes_per_forward"] // tc.num_hidden_layers
                // mesh.world_size, device)
        # the embedding: the rows the batch uses against the whole table
        key = "model.embed_tokens.weight"
        for name, fn in (("rows", lambda: params.rows(key, ids_t)),
                         ("whole", lambda: params.whole(key))):
            calls = dict(params.gathered)
            sync()
            t0 = time.perf_counter()
            got = fn()
            sync()
            out[f"embed_{name}_ms"] = (time.perf_counter() - t0) * 1e3
            out[f"embed_{name}_bytes"] = (params.gathered["bytes"]
                                          - calls["bytes"])
            del got
    else:
        experts = tc.num_experts
        rows = valid.reshape(-1)
        out["overflow"] = stats["moe_overflow"]
        out["rel_l2"] = capture_errors((aux[valid], last[valid]),
                                       (ref["aux"][valid],
                                        ref["last"][valid]), layers,
                                       tc.hidden_size)
        out["route_agreement"] = route_agreements(
            {k: v.cpu() for k, v in routes.items()}, ref["routes"], experts,
            rows, rows)
        i = ref["moe_layer"]
        cut = moe_layer_cut(params, i)
        one = moe_layer_config(tc)
        ref_out = ref["moe_out"][valid]
        fits = fitting_factor(ref["moe_routes"], valid.reshape(-1), experts,
                              mesh.world_size)
        out["fits_factor"] = fits
        for name, factor in (("full", None), ("fits", fits)):
            stats = {}
            with fp32_matmuls():
                got, _ = target_capture_forward(
                    cut, one, ids_t, mask_t, (0,),
                    compute_dtype=torch.float32, moe_impl="ep", mesh=mesh,
                    moe_capacity_factor=factor,
                    inputs_embeds=ref["moe_in"].to(device), stats=stats)
            got = got.cpu()[valid]
            out[f"layer_{i}_fp32_{name}"] = {
                "overflow": stats["moe_overflow"],
                "max_abs_err": max_err(got, ref_out),
                "excess": float(((got - ref_out).abs()
                                 - MOE_IMPL_TOL * (1 + ref_out.abs())).max())}
        del cut
        bounded = OfflineCaptureRunner(
            config, target_config=tc, target_params=params, mesh=mesh,
            moe_impl="ep", moe_capacity_factor=MOE_OVERFLOW_FACTOR)
        try:
            bounded._run_batch(ids, mask)
            out["overflow_abort"] = None
        except CapacityOverflow as exc:
            out["overflow_abort"] = str(exc)
    if on_card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del runner, params, aux, last
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def capture_mesh_rank(workdir: Path, device, overrides=()) -> None:
    """One rank of the capture-mesh phase (``chip_smoke.py
    --capture-mesh-rank WORKDIR``, started with the SPECFORGE_* env): the
    capture mesh (``build_capture_mesh``, the transport by the rule), then
    each run of ``case.json`` (``capture_mesh_run``) → ``rank{N}.json``,
    with the seconds from its launch to the mesh."""
    from specforge_tpu_torch.offline_capture.capture import build_capture_mesh
    from specforge_tpu_torch.parallel.multihost import shutdown

    case = json.loads((workdir / "case.json").read_text())
    mesh = build_capture_mesh(0, device)
    rec = {"rank": mesh.rank, "transport": mesh.transport,
           "device": str(mesh.device),
           "start_s": time.time() - case["launched"]}
    try:
        for run in case["runs"]:
            rec[run["name"]] = capture_mesh_run(run, mesh, mesh.device,
                                                workdir)
            print(json.dumps({"capture_mesh_run": run["name"],
                              "rank": mesh.rank}), flush=True)
    finally:
        shutdown()
    (workdir / f"rank{mesh.rank}.json").write_text(json.dumps(rec))


def capture_mesh_phase(runs: list, workdir: Path, device,
                       ranks: int = CAPTURE_MESH_RANKS,
                       timeout: float = CAPTURE_MESH_TIMEOUT) -> dict:
    """Slice 20: ``ranks`` processes of ``chip_smoke.py
    --capture-mesh-rank`` (NCCL with a card per rank, host-staged gloo
    when they share one) started once for ``runs`` (each a target
    directory and its reference, ``save_capture_reference``). Checks: a
    dense target's features bit-identical to one process's on every rank,
    and every rank holding fewer bytes than one process; an MoE target
    under EP: the same bits on every rank, each captured tensor within
    ``CAPTURE_REL_L2`` of the gathered capture and each MoE layer's routing
    agreeing on ``MOE_ROUTE_AGREEMENT``, no overflow at full capacity, the
    first MoE layer alone in fp32 within ``MOE_IMPL_TOL`` at full capacity
    and at its fitting factor (below ep), and the runner's abort naming a
    count at ``MOE_OVERFLOW_FACTOR`` → the ranks' records by run."""
    return finish_capture_mesh(
        launch_capture_mesh(runs, workdir, device, ranks), timeout)


def launch_capture_mesh(runs: list, workdir: Path, device,
                        ranks: int = CAPTURE_MESH_RANKS) -> dict:
    """Start the capture-mesh ranks for ``runs`` and return at once: a
    rank waits for each run's reference file, so the ranks may start
    while the last reference is still being made."""
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "case.json").write_text(json.dumps(
        {"runs": runs, "launched": time.time()}))
    launched = launch_ranks(workdir, device, [], "--capture-mesh-rank",
                            ranks)
    launched.update(runs=runs, device=device, t0=time.perf_counter())
    return launched


def finish_capture_mesh(launched: dict,
                        timeout: float = CAPTURE_MESH_TIMEOUT) -> dict:
    """Wait for ``launch_capture_mesh``'s ranks and hold their records to
    ``capture_mesh_phase``'s checks → the records by run."""
    runs, device = launched["runs"], launched["device"]
    records = join_ranks(launched, timeout, "capture mesh")
    ranks = len(records)
    out = {"ranks": ranks, "wall_s": time.perf_counter() - launched["t0"],
           "transport": records[0]["transport"],
           "start_s": [r["start_s"] for r in records]}
    want = ("gloo" if device.type != "cuda" or share_one_card(device, ranks)
            else "nccl")
    if {r["transport"] for r in records} != {want}:
        raise AssertionError(f"transports {[r['transport'] for r in records]}"
                             f", expected {want}")
    card = (torch.cuda.get_device_properties(device).total_memory
            if device.type == "cuda" else None)
    for run in runs:
        name = run["name"]
        per_rank = [r[name] for r in records]
        if len({r["digest"] for r in per_rank}) != 1:
            raise AssertionError(f"{name}: the ranks' features differ")
        for rank, rec in enumerate(per_rank):
            if card is not None and rec["peak_bytes"] >= card:
                raise AssertionError(f"{name}: rank {rank} peaked at "
                                     f"{rec['peak_bytes']} bytes, the card "
                                     f"holds {card}")
            if rec["resident_bytes"] >= rec["one_process_bytes"]:
                raise AssertionError(
                    f"{name}: rank {rank} holds {rec['resident_bytes']} "
                    f"bytes, one process {rec['one_process_bytes']}")
            if "aux_bit_identical" in rec:
                if not (rec["aux_bit_identical"]
                        and rec.get("last_bit_identical", True)):
                    raise AssertionError(f"{name}: rank {rank}'s features "
                                         "differ from one process's")
                continue
            check(f"{name}: overflow at full capacity", rec["overflow"], 0)
            for key, err in rec["rel_l2"].items():
                check(f"{name}: EP vs gathered, {key} (relative L2)", err,
                      CAPTURE_REL_L2)
            for key, share in rec["route_agreement"].items():
                check(f"{name}: EP vs gathered routing agreement, {key} "
                      "(1 - share)", 1.0 - share, 1.0 - MOE_ROUTE_AGREEMENT)
            if not rec["fits_factor"] < ranks:
                raise AssertionError(f"{name}: the fitting factor "
                                     f"{rec['fits_factor']} bounds nothing")
            for key in [k for k in rec if k.endswith(("_full", "_fits"))]:
                check(f"{name}: {key} overflow", rec[key]["overflow"], 0)
                check(f"{name}: {key} vs gathered (|e - g| - {MOE_IMPL_TOL}"
                      " * (1 + |g|))", rec[key]["excess"], 0.0)
            abort = rec["overflow_abort"] or ""
            match = re.match(r"EP MoE capacity overflow: (\d+) expert", abort)
            if not match or int(match.group(1)) <= 0:
                raise AssertionError(f"{name}: the runner did not abort at "
                                     f"factor {MOE_OVERFLOW_FACTOR}: {abort!r}")
        out[name] = per_rank
    return out


def emit_capture_mesh(results: dict, reduced: dict) -> None:
    emit({"phase": "capture_mesh",
          "command": "python -m specforge_tpu_torch.offline_capture.prepare "
                     "... --shard-over-devices [N] [--moe-impl ep "
                     "[--moe-capacity-factor F]]",
          "factors": {"fits": "the least that holds the fullest rank's "
                              "rows (fits_factor)",
                      "overflows": MOE_OVERFLOW_FACTOR},
          "tolerances": {"dense": "bit-identical to one process",
                         "rel_l2": CAPTURE_REL_L2,
                         "route_agreement": MOE_ROUTE_AGREEMENT,
                         "moe_layer_fp32": f"|e - g| <= {MOE_IMPL_TOL} * "
                                           "(1 + |g|), no TF32"},
          "reduced": reduced, **results})


def reference_cut(target: Path, depth: int, root: Path) -> Path:
    """The first ``depth`` layers of the HF directory ``target`` as a
    directory of their own: its config cut, an index of only their
    tensors, links to the shards that hold them (no bytes copied)."""
    root.mkdir(parents=True, exist_ok=True)
    config = json.loads((target / "config.json").read_text())
    config["num_hidden_layers"] = depth
    (root / "config.json").write_text(json.dumps(config))
    index = json.loads((target / "model.safetensors.index.json").read_text())
    keep = {}
    for key, shard in index["weight_map"].items():
        match = re.match(r"model\.layers\.(\d+)\.", key)
        if match is None or int(match.group(1)) < depth:
            keep[key] = shard
    for shard in set(keep.values()):
        (root / shard).symlink_to(target / shard)
    (root / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": keep}))
    return root


def padded_conversations(vocab_size: int, seed: int, batch: int,
                         min_len: int, max_length: int) -> tuple:
    """Phase 5a's conversations (``SpreadTokenizer``, the qwen template)
    as one padded batch → (ids, mask)."""
    tokenizer = SpreadTokenizer(vocab_size)
    parsed = build_dataset(synthetic_conversations(
        batch, tokenizer, seed, min_len, max_length), tokenizer, "qwen",
        max_length)
    ids = np.zeros((batch, max_length), np.int64)
    mask = np.zeros((batch, max_length), np.int64)
    for j, p in enumerate(parsed[:batch]):
        ids[j, :len(p.input_ids)] = p.input_ids
        mask[j, :len(p.input_ids)] = 1
    return ids, mask


def capture_mesh_only_phase(seed: int, device=None, *,
                            dense=LLAMA3_70B_TARGET,
                            moe=DEEPSEEK_V2_LITE_TARGET,
                            batch=CAPTURE_BATCH, min_len=1536,
                            max_length=MAX_LEN, ranks=None,
                            parts=("dense", "moe")) -> dict:
    """``--capture-mesh-only``, a rank per card (at least 2; on one card 2
    ranks share it): Llama-3-70B's dense target at ``LLAMA_MESH_DEPTH``
    layers (or as many as the disk holds) over fsdp, its capture layers
    ``LLAMA_MESH_LAYERS`` held bit for bit against one process capturing
    a cut of its first ``LLAMA_REF_DEPTH`` layers; then DeepSeek-V2-Lite
    at all 27 layers under EP (capture layers by the EAGLE3 rule), held as
    the default run holds it. A ``capture_mesh`` line each (``parts``:
    which of the two) → their results."""
    device = device or torch.device("cuda")
    on_card = device.type == "cuda"
    ranks = ranks or max(2, torch.cuda.device_count() if on_card else 2)
    providers = builtin_algorithm_registry().resolve("eagle3").providers
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if "dense" in parts:
            config = dict(dense)
            (tmp / "probe").mkdir()
            (tmp / "probe" / "config.json").write_text(json.dumps(config))
            probe = TargetConfig.from_file(str(tmp / "probe"))
            per_layer = 2 * sum(math.prod(shape) for shape, _ in
                                layer_shapes(probe, config, 0).values())
            # room for the embedding and the head, then for the MoE target
            free = (shutil.disk_usage(tmp).free - 8e9
                    - 4 * config["vocab_size"] * config["hidden_size"])
            depth = max(LLAMA_REF_DEPTH, min(LLAMA_MESH_DEPTH,
                                             int(free // per_layer)))
            config["num_hidden_layers"] = depth
            t0 = time.perf_counter()
            target = write_capture_target(tmp / "dense", config, device,
                                          seed, TARGET_STD)
            write_s = time.perf_counter() - t0
            ids, mask = padded_conversations(config["vocab_size"], seed,
                                             batch, min_len, max_length)
            cut = reference_cut(target, LLAMA_REF_DEPTH, tmp / "dense_cut")
            runner = OfflineCaptureRunner(OfflineCaptureConfig(
                str(cut), str(tmp / "unused"), LLAMA_MESH_LAYERS, max_length,
                batch), moe_impl="gathered", device=device)
            save_capture_reference(runner, ids, mask, tmp / "dense_ref.pt")
            del runner
            # one process would hold the whole target
            ref = torch.load(tmp / "dense_ref.pt")
            ref["resident_bytes"] = ref_bytes(target)
            torch.save(ref, tmp / "dense_ref.pt")
            del ref
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            dense_results = capture_mesh_phase(
                [{"name": "dense_fsdp", "target": str(target),
                  "ref": str(tmp / "dense_ref.pt"), "compare_last": False}],
                tmp / "mesh_dense", device, ranks)
            dense_results.update(target_write_s=write_s, depth=depth,
                                 target_bytes=ref_bytes(target))
            full = dense["num_hidden_layers"]
            emit_capture_mesh(dense_results, {
                "weights": f"random, from --seed (std {TARGET_STD})",
                "depth": f"{depth} of {full} layers, "
                         f"{dense_results['target_bytes']} bytes" + (
                             "" if depth == LLAMA_MESH_DEPTH else
                             f" ({LLAMA_MESH_DEPTH} did not fit the disk)"),
                "reference": f"one process over the first "
                             f"{LLAMA_REF_DEPTH} layers, capture layers "
                             f"{list(LLAMA_MESH_LAYERS)} bit for bit (its "
                             "last hidden is another depth's)",
                "batch": f"{batch} conversations padded to {max_length}"})
            shutil.rmtree(tmp / "dense")
            results["dense"] = dense_results
        if "moe" in parts:
            t0 = time.perf_counter()
            target = write_capture_target(tmp / "moe", dict(moe), device,
                                          seed, TARGET_STD, MOE_SHARD_LAYERS)
            write_s = time.perf_counter() - t0
            ids, mask = padded_conversations(moe["vocab_size"], seed, batch,
                                             min_len, max_length)
            layers = tuple(providers.resolve_capture_layers(
                None, moe["num_hidden_layers"]))
            runner = OfflineCaptureRunner(OfflineCaptureConfig(
                str(target), str(tmp / "unused"), layers, max_length, batch),
                moe_impl="gathered", device=device)
            save_capture_reference(runner, ids, mask, tmp / "moe_ref.pt")
            del runner
            gc.collect()
            if on_card:
                torch.cuda.empty_cache()
            moe_results = capture_mesh_phase(
                [{"name": "moe_ep", "target": str(target),
                  "ref": str(tmp / "moe_ref.pt")}],
                tmp / "mesh_moe", device, ranks)
            moe_results.update(target_write_s=write_s,
                               target_bytes=ref_bytes(target))
            emit_capture_mesh(moe_results, {
                "weights": f"random, from --seed (std {TARGET_STD})",
                "capture_layers": f"{list(layers)}, the EAGLE3 rule",
                "batch": f"{batch} conversations padded to {max_length}"})
            results["moe"] = moe_results
    return results


def ref_bytes(target: Path) -> int:
    """The bytes of a target directory's safetensors files."""
    return sum(p.stat().st_size for p in target.iterdir()
               if p.suffix == ".safetensors")


def target_families_phase(seed: int, device=None) -> dict:
    """Slice 17's families on the card: each target of
    ``tests/_torch_targets.TINY_FAMILIES`` (the CPU parity tests' tiny
    checkpoints, from the seed) through the port's fp32 forward on CUDA
    against its fp32 forward on the CPU, and for the MoE families
    ``moe_impl="dense"`` against ``gathered`` on CUDA with the same
    routing, all without TF32, within ``MOE_IMPL_TOL`` → per family the
    largest errors."""
    device = device or torch.device("cuda")
    results = {}
    gen = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp, fp32_matmuls():
        for family in TINY_FAMILIES:
            root = write_family_target(Path(tmp) / family, family, seed)
            tc = TargetConfig.from_file(root)
            ids = torch.as_tensor(gen.integers(0, tc.vocab_size, (2, 16)))
            mask = torch.ones_like(ids)
            mask[1, 11:] = 0
            layers = (-1, 1, tc.num_hidden_layers - 1)
            valid = mask.bool()
            runs = {}
            for where, impl in (("cpu", "gathered"), ("cuda", "gathered"),
                                ("cuda", "dense")):
                if impl == "dense" and family not in MOE_FAMILIES:
                    continue
                dev = torch.device("cpu") if where == "cpu" else device
                params = load_target_params(root, tc, torch.float32, dev)
                routing = {}
                out = target_capture_forward(params, tc, ids, mask, layers,
                                             moe_impl=impl, routing=routing)
                runs[where, impl] = ([t.cpu()[valid] for t in out],
                                     {k: v.cpu() for k, v in routing.items()})
            errors = {}
            for name, pair in (("cuda_vs_cpu", ("cpu", "gathered")),
                               ("dense_vs_gathered", ("cuda", "dense"))):
                if pair not in runs:
                    continue
                ref, ref_routes = runs["cuda", "gathered"]
                got, got_routes = runs[pair]
                excess = max(float(((a - b).abs()
                                    - MOE_IMPL_TOL * (1 + b.abs())).max())
                             for a, b in zip(got, ref))
                check(f"{family}: {name} (|a - b| - {MOE_IMPL_TOL} * "
                      "(1 + |b|))", excess, 0.0)
                same = all(torch.equal(got_routes[k], ref_routes[k])
                           for k in ref_routes)
                check(f"{family}: {name}, MoE layers routing differently",
                      0.0 if same else 1.0, 0.0)
                errors[name] = max(max_err(a, b) for a, b in zip(got, ref))
            results[family] = errors
    return results


def emit_target_families(seed: int) -> None:
    emit({"phase": "target_families",
          "families": target_families_phase(seed),
          "tolerance": f"|a - b| <= {MOE_IMPL_TOL} * (1 + |b|), fp32, "
                       "no TF32"})
    torch.cuda.empty_cache()


def offline_leftovers_phase(seed: int, run_dir_warm_start: dict,
                            mesh_refs: Optional[Path] = None) -> None:
    """Every run of ``LEFTOVER_RUNS`` at full width, one line each (the
    DeepSeek-V2-Lite draft's after ``moe_capture_phase``'s own, and the
    capture mesh's given ``mesh_refs``), then the phase's line with the
    run-directory warm start of the EAGLE3 training phase."""
    t0 = time.perf_counter()
    launches = {}
    for name, spec in LEFTOVER_RUNS.items():
        if spec["features"] == "captured":
            launches[name] = moe_capture_phase(seed, MOE_CAPTURE_DEPTH,
                                               mesh_refs)
            continue
        with tempfile.TemporaryDirectory() as tmp:
            results, counts = run_leftover(spec, torch.device("cuda"), seed,
                                           Path(tmp))
        launches[name] = counts
        emit_leftover(name, spec, results, counts)
        torch.cuda.empty_cache()
    emit({"phase": "offline_leftovers", "launches": launches,
          "run_dir_warm_start": run_dir_warm_start,
          "seconds": time.perf_counter() - t0})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    # one rank of the USP or the mesh phase, started by the phase itself
    parser.add_argument("--usp-rank", metavar="WORKDIR",
                        help=argparse.SUPPRESS)
    parser.add_argument("--mesh-rank", metavar="WORKDIR",
                        help=argparse.SUPPRESS)
    parser.add_argument("--capture-mesh-rank", metavar="WORKDIR",
                        help=argparse.SUPPRESS)
    parser.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    parser.add_argument("--set", action="append", default=[],
                        help=argparse.SUPPRESS)
    # the USP phase alone (its ranks and the one process beside them): on a
    # machine with a card per rank, its ranks talk NCCL
    parser.add_argument("--usp-only", action="store_true",
                        help="run only the USP training phase")
    # the mesh phase alone (its ranks and the one process beside them): on
    # a machine with a card per rank, its ranks talk NCCL
    parser.add_argument("--mesh-only", action="store_true",
                        help="run only the dp x fsdp (and USP) mesh phase")
    # the offline leftovers' drafts alone (no run-directory warm start: the
    # EAGLE3 training phase makes its checkpoint)
    parser.add_argument("--leftovers-only", action="store_true",
                        help="run only the offline_leftovers training runs")
    # capture at Qwen3-8B width and all 36 layers, the training phase on
    # the captured features, the exports of its checkpoint and serving
    # them, the target
    # families, then the MoE capture at all 27 layers of DeepSeek-V2-Lite
    # and its draft's training on those features, alone
    parser.add_argument("--capture-only", action="store_true",
                        help="run only the captures (all layers), their "
                             "training runs, export, serving and the "
                             "families")
    # the spread of bf16 logits between the verify block and greedy
    # decoding at all 36 target layers, sound and with planted faults
    parser.add_argument("--serving-gaps", action="store_true",
                        help="run only the bf16 near-tie study of serving "
                             "(all 36 target layers)")
    # the capture (6 layers) and the block serving phase alone
    parser.add_argument("--block-serving-only", action="store_true",
                        help="run only the capture and the DFlash-family "
                             "block serving phase")
    # the online stack alone, its target at all 36 layers
    parser.add_argument("--online-only", action="store_true",
                        help="run only the online phase (all 36 target "
                             "layers)")
    # the capture mesh alone, a rank per card: Llama-3-70B (fsdp) and
    # DeepSeek-V2-Lite (EP) at depths one card cannot hold or all layers
    parser.add_argument("--capture-mesh-only", nargs="?", const="all",
                        choices=("all", "dense", "moe"),
                        help="run only the capture mesh (a rank per card): "
                             "both targets, or the dense or the MoE one")
    args = parser.parse_args()
    if args.usp_rank:
        usp_rank(Path(args.usp_rank), torch.device(args.device), args.set)
        return 0
    if args.mesh_rank:
        mesh_rank(Path(args.mesh_rank), torch.device(args.device), args.set)
        return 0
    if args.capture_mesh_rank:
        capture_mesh_rank(Path(args.capture_mesh_rank),
                          torch.device(args.device), args.set)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    smi = device_facts()
    if args.serving_gaps:
        results = serving_gaps_phase(args.seed)
        emit({"phase": "serving_gaps",
              "target": "Qwen3-8B's shape, random bf16 weights (std "
                        f"{TARGET_STD}) from --seed and the target seed",
              "draft": "random, configs/qwen3-8b-eagle3.json",
              "nvidia_smi": smi, **results})
        check_serving_gaps(results)
        print(smi, flush=True)
        return 0
    if args.capture_mesh_only:  # no kernel is on this path
        capture_mesh_only_phase(
            args.seed, parts=("dense", "moe") if args.capture_mesh_only
            == "all" else (args.capture_mesh_only,))
        print(smi, flush=True)
        return 0
    build()
    if args.leftovers_only:
        offline_leftovers_phase(args.seed, None)
        print(smi, flush=True)
        return 0
    if args.online_only:
        online_only_phase(args.seed)
        print(smi, flush=True)
        return 0
    if args.block_serving_only:
        block_serving_only_phase(args.seed)
        print(smi, flush=True)
        return 0
    if args.capture_only:
        capture_and_train_phase(args.seed,
                                QWEN3_8B_TARGET["num_hidden_layers"])
        emit_target_families(args.seed)
        moe_capture_phase(args.seed,
                          DEEPSEEK_V2_LITE_TARGET["num_hidden_layers"])
        print(smi, flush=True)
        return 0
    if not args.usp_only:
        mesh_phase(args.seed)
        if args.mesh_only:
            print(smi, flush=True)
            return 0
    # the USP phase next: its 4 ranks may share the card, and this process
    # holds none of its memory yet (the kernel phases leave some behind)
    with tempfile.TemporaryDirectory() as tmp:
        results, usp_counts = run_usp_training(
            CONFIG, torch.device("cuda"), args.seed, Path(tmp))
    check_usp_counts(results["rank_launches"], results["micro_batches"])
    shared = results["transport"] == "gloo"
    emit({"phase": "usp_training",
          "config": str(USP_EXAMPLE.relative_to(REPO)),
          "draft_config": str(CONFIG.relative_to(REPO)),
          "grid": {"sp_ulysses": USP_GRID[0], "sp_ring": USP_GRID[1]},
          "batch": 1, "max_length": USP_MAX_LEN, "ttt_length": TTT,
          "reduced": {"max_length": f"{USP_MAX_LEN}, not 32768 (8192 ran "
                                    "out of memory with the 4 ranks on one "
                                    "card)",
                      "grid": "sp 2x2, not 2x4: " + (
                          "the 4 ranks share one card" if shared else
                          "4 cards, one a rank"),
                      "accumulation_steps":
                          f"{results['accumulation_steps']}, not 8" + (
                              " (2 on 4 cards; the script's time)"
                              if shared else ""),
                      "steps": f"{results['optimizer_steps']} optimizer "
                               f"steps over {results['files']} files of "
                               f"{USP_MIN_LEN}-{USP_MAX_LEN} tokens",
                      "checkpoints": "at steps 1 and 2" if results["resume"]
                      else "at the end; no 4-rank resume on one card (the "
                           "script's time; the mesh phase resumes 4 ranks)"},
          "launches_summed_over_ranks": usp_counts,
          "tolerances": {"step1_loss_rtol": TRAIN_STEP1_RTOL,
                         "later_loss_rtol": TRAIN_DRIFT_RTOL,
                         "grad_cosine": GRAD_COSINE,
                         "grad_norm_rtol": GRAD_NORM_RTOL},
          **results})
    if args.usp_only:
        print(smi, flush=True)
        return 0
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kernels = [attention_kernel_phase(gen), ce_kernel_phase(gen)]
    kernels += [ce_backward_phase(gen), *attention_backward_phase(gen)]
    torch.cuda.empty_cache()
    kernels += dflash_kernel_phase(gen)
    torch.cuda.empty_cache()
    kernels += cod_kernel_phase(gen)
    torch.cuda.empty_cache()
    kernels += lse_kernel_phase(gen)
    torch.cuda.empty_cache()

    cfg = Eagle3Config.from_file(CONFIG)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        kernel, plain, counted = run_slice(
            cfg, torch.device("cuda"), args.seed, Path(tmp))
    for name, n in counted["launches"].items():
        expected = TTT * counted["forwards"]
        if n != expected:
            raise AssertionError(
                f"{name}: {n} launches on the main path, expected {expected}"
                f" ({TTT} per forward)")
    worst = compare_slice(kernel, plain)
    ms = kernel["forward_loss_ms"]
    emit({
        "phase": "slice",
        "config": str(CONFIG.relative_to(REPO)),
        "batch": BATCH, "max_length": MAX_LEN, "ttt_length": TTT,
        "kernel": kernel, "plain": plain, "counted": counted,
        "max_rel_diff_vs_plain": worst, "rtol": SLICE_RTOL,
        "forward_loss_ms": ms,
        "tokens_per_s": BATCH * MAX_LEN / (ms / 1e3),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    })
    del kernel, plain
    torch.cuda.empty_cache()

    mesh_refs = Path(tempfile.mkdtemp(prefix="capture_mesh_"))
    training, counts, families, serving_launches = capture_and_train_phase(
        args.seed, CAPTURE_DEPTH, mesh_refs)
    emit_target_families(args.seed)

    # the Domino, DSpark and DFlash phases ran inside the capture phase, on
    # its features
    family_counts = {}
    for kind, (results, family_counts[kind]) in families.items():
        check_family_counts(family_counts[kind], results["micro_batches"],
                            json.loads(BLOCK_CONFIG_FILES[kind].read_text())[
                                "num_hidden_layers"])
    for kind, cfg_path in (("dspark_block7", DSPARK7_CONFIG),):
        draft = json.loads(cfg_path.read_text())
        with tempfile.TemporaryDirectory() as tmp:
            results, family_counts[kind] = run_family_training(
                kind, cfg_path, torch.device("cuda"), args.seed, Path(tmp))
        check_family_counts(family_counts[kind], results["micro_batches"],
                            draft["num_hidden_layers"])
        emit_family(kind, cfg_path, results, family_counts[kind])
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        results, peagle_counts = run_peagle_training(
            PEAGLE_CONFIG, torch.device("cuda"), args.seed, Path(tmp))
    layers = json.loads(PEAGLE_CONFIG.read_text())["num_hidden_layers"]
    check_peagle_counts(peagle_counts, results["micro_batches"], layers)
    emit({"phase": "peagle_training",
          "config": str(PEAGLE_EXAMPLE.relative_to(REPO)),
          "draft_config": str(PEAGLE_CONFIG.relative_to(REPO)),
          "batch": BATCH, "max_length": 1024, "accumulation_steps": ACCUM,
          "row_sparse_embedding": True, "launches": peagle_counts,
          "tolerances": {"step1_loss_rtol": TRAIN_STEP1_RTOL,
                         "later_loss_rtol": TRAIN_DRIFT_RTOL,
                         "grad_cosine": GRAD_COSINE,
                         "grad_norm_rtol": GRAD_NORM_RTOL,
                         "embedding_update_rtol": EMBED_UPDATE_RTOL},
          **results})
    torch.cuda.empty_cache()

    offline_leftovers_phase(args.seed, training["run_dir_warm_start"],
                            mesh_refs)
    shutil.rmtree(mesh_refs)

    # each kernel's launches from its own main path: the EAGLE3 kernels from
    # the EAGLE3 training run, the DFlash kernels from the Domino run, the
    # COD kernels from the P-EAGLE run, the LSE kernels from the USP run
    # (summed over its 4 ranks)
    counts.update(family_counts["domino"])
    counts.update({k: v for k, v in peagle_counts.items()
                   if k.startswith("cod_")})
    counts.update(usp_counts)
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["name"] in training["online_launches"]:
            # the same kernel on slice 18's path, the online consumer
            k["online_launches"] = training["online_launches"][k["name"]]
        if k["name"] == "dflash_attention_fwd":
            # and on the block decoder's: the counted runs (the
            # program's warm-ups and capture) and one a draft layer each
            # graph replay, by served draft
            k["serving_launches"] = serving_launches
        k["kernel_ms"] = k["ms"]
        if k["name"] in HOPPER_ROUTE:
            k["route_note"] = "wgmma, TMA"
    emit({"kernels": kernels})
    print(smi, flush=True)
    # one card is used, whatever the machine holds
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
