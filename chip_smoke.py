#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

Usage: ``python3 chip_smoke.py [--seed N]`` from the repository root.

Phases, each printing JSON lines:

1. device facts: torch/CUDA versions, ``nvidia-smi`` name and power limit,
   the ``nvcc`` version;
2. build: every kernel source of ``specforge_tpu_torch/csrc`` compiled by
   ``nvcc`` for ``sm_90a`` (in parallel) into one library;
3. kernels, at the shapes of the slices: each kernel (the TTT attention and
   fused CE forwards, the fused CE backward and the two TTT attention
   backward kernels) is held against its plain PyTorch version on the card,
   in the working dtype, and timed with CUDA events (median of 20 runs after
   3 warm-ups) beside the plain version, one PyTorch library call as a
   yardstick, and its bound;
4. slice 1: the EAGLE3 offline TTT forward at the full Qwen3-8B EAGLE3 width
   (``configs/qwen3-8b-eagle3.json``, random weights from ``--seed``), from
   feature files written and read back by the port's data plane, through
   ``Evaluator.run`` and ``Eagle3TrainStrategy.forward_loss`` with the
   compact teacher; the kernel launch counters must show 7 launches of each
   forward kernel per forward, and the metrics must agree with the same
   batches run through the plain dense attention and reference CE;
5. slice 2, training: ``specforge_tpu_torch.cli.main(["train", ...])`` on
   ``examples/qwen3-8b-eagle3-offline.json`` pointed at feature files and a
   random HF-layout target directory written here, for 4 optimizer steps of
   2 micro-batches (B=2, S=2048, TTT 7, compact teacher), with an eval and
   checkpoints; exactly 7 launches of every kernel per micro-batch (and of
   the forward kernels per eval forward); the kernel path against the plain
   path (dense attention, reference CE) from the same initial weights; a
   resume from the step-2 checkpoint that must reach the same weights; the
   micro-step and optimizer-step times of the trainer's own train step,
   peak memory with and without ``compute_params_dtype``, and one profiled
   micro-step;
6. the kernels line, then the card line, then ``{"ok": true, ...}``.

Any failed check raises: the script then exits non-zero with a traceback and
prints no result. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from specforge_tpu_torch import cli
from specforge_tpu_torch.algorithms.eagle3.model import OnlineEagle3Model
from specforge_tpu_torch.application.composition import build_training_run
from specforge_tpu_torch.config.schema import load_config
from specforge_tpu_torch.data.collator import CollatorConfig, PaddingCollator
from specforge_tpu_torch.eval.evaluator import Evaluator
from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    LlamaEagle3Draft,
)
from specforge_tpu_torch.ops import attention_cuda, cuda_lib, loss_cuda
from specforge_tpu_torch.ops.loss import log_softmax_loss_reference
from specforge_tpu_torch.runtime.data_plane.feature_dataloader import (
    FeatureDataLoader,
)
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    read_feature_specs,
    save_feature_file,
)
from specforge_tpu_torch.runtime.data_plane.feature_store import FileFeatureStore
from specforge_tpu_torch.runtime.data_plane.offline_reader import (
    OfflineManifestReader,
)
from specforge_tpu_torch.training.checkpoint import CheckpointManager
from specforge_tpu_torch.training.optimizer import global_norm
from specforge_tpu_torch.training.strategies import Eagle3TrainStrategy
from specforge_tpu_torch.training.train_step import make_train_step
from specforge_tpu_torch.training.vocab_mapping import (
    load_vocab_mapping,
    save_vocab_mapping,
)

REPO = Path(__file__).resolve().parent
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
# the training slice: examples/qwen3-8b-eagle3-offline.json, cut to 4
# optimizer steps of 2 micro-batches
TRAIN_FILES, EVAL_FILES, ACCUM = 16, 4, 2


def emit(obj) -> None:
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


def build() -> None:
    t0 = time.perf_counter()
    cuda_lib.library()
    ptxas = [
        line.strip() for line in (cuda_lib.build_log or "").splitlines()
        if "registers" in line or "spill" in line
    ]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": cuda_lib.build_seconds,
          "sources": list(cuda_lib.SOURCES), "ptxas": ptxas})


# --------------------------------------------------------------------------
# kernels against their plain versions
# --------------------------------------------------------------------------

def attention_inputs(gen, s, n_branches, padded):
    b, h, kvh, d = BATCH, 32, 8, 128
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


def attention_kernel_phase(gen) -> dict:
    fwd = attention_cuda.ttt_flash_attention_fwd
    plain = attention_cuda.ttt_flash_attention_plain
    worst = 0.0
    timed = []
    cases = [(MAX_LEN, nb, True) for nb in range(TTT)]
    cases += [(MAX_LEN, 0, False), (MAX_LEN, 6, False),
              (MAX_LEN - 1, 0, True), (MAX_LEN - 1, 6, True)]
    for s, nb, padded in cases:
        q, keys, values, key_valid = attention_inputs(gen, s, nb, padded)
        out, m, l = fwd(q, keys, values, key_valid)
        torch.cuda.synchronize()
        ref_out, ref_m, ref_l = plain(q, keys, values, key_valid)
        err = max_err(out, ref_out)
        m_err = max_err(m, ref_m) / (1.0 + float(ref_m.abs().max()))
        l_err = float(((l - ref_l).abs() / ref_l.clamp(min=1e-30)).max())
        check(f"ttt attention S={s} NB={nb} padded={padded}", err, ATTN_TOL)
        check(f"ttt attention m S={s} NB={nb}", m_err, STAT_RTOL)
        check(f"ttt attention l S={s} NB={nb}", l_err, STAT_RTOL)
        worst = max(worst, err)
        row = {"phase": "kernel", "name": "ttt_flash_attention_fwd",
               "S": s, "branches": nb, "padded": padded,
               "max_abs_err": err, "m_rel_err": m_err, "l_rel_err": l_err,
               "tol": ATTN_TOL}
        if s == MAX_LEN and padded:
            # the main path's seven launches: one per branch count 0..6
            row["ms"] = median_ms(lambda: fwd(q, keys, values, key_valid))
            row["plain_ms"] = median_ms(
                lambda: plain(q, keys, values, key_valid))
            row["library_ms"] = median_ms(
                sdpa_yardstick(q, keys, values, key_valid))
            row["bound"] = attention_bound_ms(q, keys, key_valid)
            timed.append(row)
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
    path's shapes (0..6 branches, padded key_valid; S=2047; unpadded)."""
    fwd = attention_cuda.ttt_flash_attention_fwd
    worst = {"dq": 0.0, "dkv": 0.0}
    timed = []
    cases = [(MAX_LEN, nb, True) for nb in range(TTT)]
    cases += [(MAX_LEN - 1, 0, True), (MAX_LEN - 1, 6, True),
              (MAX_LEN, 6, False)]
    for s, nb, padded in cases:
        q, keys, values, key_valid = attention_inputs(gen, s, nb, padded)
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
                  f"padded={padded} (max|err| / max|ref|)", e, ATTN_BWD_RTOL)
            worst[name] = max(worst[name], e)
        row = {"phase": "kernel", "name": "ttt_attention_bwd", "S": s,
               "branches": nb, "padded": padded, "rel_err_dq": err["dq"],
               "rel_err_dkv": err["dkv"],
               "max_abs_err_dq": max_err(dq, ref_dq),
               "max_abs_err_dkv": max(max_err(dks[0], ref_dks[0]),
                                      max_err(dvs[0], ref_dvs[0])),
               "tol": f"{ATTN_BWD_RTOL} * max|ref|"}
        if s == MAX_LEN and padded:
            valid = key_valid.to(torch.int32)
            delta = attention_cuda.backward_delta(out, dout, q.shape[1])
            args = (q, keys, values, valid, dout, m, l, delta)
            row["dq_ms"] = median_ms(
                lambda: attention_cuda.ttt_attention_bwd_dq(*args))
            row["dkv_ms"] = median_ms(
                lambda: attention_cuda.ttt_attention_bwd_dkv(*args))
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
              # gradient at once; each stands beside both kernels
              "plain_ms": mean("plain_ms"), "library_ms": mean("library_ms")}
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
# the slice: EAGLE3 offline TTT forward at Qwen3-8B width
# --------------------------------------------------------------------------

def write_features(root: Path, cfg: Eagle3Config, seed: int, n_files: int,
                   min_len: int, max_len: int) -> None:
    """Offline feature files in the layout of tests/_fixtures.py, written by
    the port's writer from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    h = cfg.resolved_target_hidden_size
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        n = int(torch.randint(min_len, max_len + 1, (1,), generator=gen))
        tensors = {
            "input_ids": torch.randint(0, cfg.vocab_size, (n,), generator=gen),
            "loss_mask": (torch.rand(n, generator=gen) > 0.25).to(torch.int64),
            "hidden_state": torch.randn(n, 3 * h, generator=gen).to(
                torch.bfloat16),
            "target": torch.randn(n, h, generator=gen).to(torch.bfloat16),
        }
        save_feature_file(str(root / f"sample-{i:04d}.sft"), tensors,
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


def write_target_dir(root: Path, cfg: Eagle3Config, device, seed: int,
                     std: float) -> Path:
    """A random HF-layout target directory (``config.json`` and one
    ``model.safetensors`` with the bf16 lm_head and embedding), written by
    the port's safetensors writer, so the trainer loads them for real."""
    root.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    shape = (cfg.vocab_size, cfg.resolved_target_hidden_size)
    tensors = {
        key: (torch.randn(*shape, generator=gen, device=device) * std).to(
            torch.bfloat16).cpu()
        for key in ("lm_head.weight", "model.embed_tokens.weight")
    }
    save_feature_file(str(root / "model.safetensors"), tensors)
    (root / "config.json").write_text(json.dumps({
        "vocab_size": cfg.vocab_size, "hidden_size": shape[1],
        "tie_word_embeddings": False,
    }))
    return root


def training_run_json(workdir: Path, draft_config: Path, target: Path,
                      max_length: int) -> Path:
    """``examples/qwen3-8b-eagle3-offline.json``, read as data, pointed at
    this run's directories and cut to 4 optimizer steps of 2 micro-batches
    (save every 2 steps, eval at the end of the epoch)."""
    raw = json.loads(EXAMPLE.read_text())
    raw["run_id"] = "smoke"
    raw["output_dir"] = str(workdir / "runs")
    raw["model"].update(target_model_path=str(target),
                        draft_config_path=str(draft_config))
    raw["data"].update(train_data_path=str(workdir / "train"),
                       eval_data_path=str(workdir / "eval"),
                       max_length=max_length, num_workers=2)
    raw["training"].update(num_epochs=1, accumulation_steps=ACCUM,
                           save_interval=2, eval_interval=0, log_interval=1)
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
    return float(stats["loss"]) / len(window), grads


def compare_grads(kernel: dict, plain: dict) -> dict:
    """Per parameter: cosine and relative norm difference of two gradients."""
    out = {}
    for name, a in kernel.items():
        b = plain[name]
        a = a.to(b.device)
        cos = float(F.cosine_similarity(a.reshape(1, -1), b.reshape(1, -1)))
        na, nb = float(a.norm()), float(b.norm())
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
    optimizer step (global norm, clip and AdamW), one profiled micro-step,
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
    grads, _ = step.accumulate(trainer.state, stack_window(window),
                               trainer.frozen)
    opt_times = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        trainer.state.opt_state = trainer.optimizer.step(
            trainer.state.params, grads, trainer.state.opt_state,
            global_norm(grads))
        sync()
        opt_times.append((time.perf_counter() - t0) * 1e3)
    del grads
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
        compute_params_dtype="bfloat16")
    for name, train_step in ((default, step), ("bfloat16", cast)):
        sync()
        torch.cuda.reset_peak_memory_stats()
        trainer.state, _ = train_step(trainer.state, stack_window(window),
                                      trainer.frozen)
        sync()
        results[f"train_step_peak_bytes_compute_params_dtype_{name}"] = (
            torch.cuda.max_memory_allocated())
    return results


def run_training(cfg_path: Path, device, seed: int, workdir: Path, *,
                 max_length=MAX_LEN, min_len=1536, head_std=0.02,
                 overrides=()) -> dict:
    """Slice 2 end to end; returns the results and the launch counts of the
    main path (the ``cli train`` run), which are set to 0 just before it and
    read just after."""
    cfg = Eagle3Config.from_file(cfg_path)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    write_features(workdir / "train", cfg, seed, TRAIN_FILES, min_len,
                   max_length)
    write_features(workdir / "eval", cfg, seed + 100, EVAL_FILES, min_len,
                   max_length)
    target = write_target_dir(workdir / "target", cfg, device, seed, head_std)
    run_json = training_run_json(workdir, cfg_path, target, max_length)
    runs = workdir / "runs"
    overrides = list(overrides)
    device_args = [] if on_card else ["--device", str(device)]

    def trainer_for(*extra):
        config = load_config(str(run_json), overrides + list(extra))
        return build_training_run(config, device=None if on_card else device)

    # the main path: cli train, 4 optimizer steps + eval + checkpoints
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

    # resume: a fresh kernel-path run from the uninterrupted run's step-2
    # checkpoint. Until its fit restores that checkpoint it holds the same
    # initial weights as the cli run, so it first gives the kernel path's
    # step-1 loss and gradients (kept on the host until the plain path's)
    resumed = trainer_for('run_id="resumed"', "training.save_interval=0",
                          f"training.resume_from={runs / 'smoke-step2'}")
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
    results["resume"] = {"from": "smoke-step2", "steps": resumed.state.step,
                         "bit_exact": exact, "max_rel_err": worst}
    results.update(measure_kernel_path(resumed, window, sync))
    del resumed
    if on_card:
        torch.cuda.empty_cache()

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
    plain.fit()
    del plain
    plain_steps = step_records(runs, "plain")
    for step_dir in runs.glob("plain-step*"):
        shutil.rmtree(step_dir)
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    smi = device_facts()
    build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kernels = [attention_kernel_phase(gen), ce_kernel_phase(gen)]
    kernels += [ce_backward_phase(gen), *attention_backward_phase(gen)]
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

    with tempfile.TemporaryDirectory() as tmp:
        training, counts = run_training(CONFIG, torch.device("cuda"),
                                        args.seed, Path(tmp))
    check_training_counts(counts, training["micro_batches"],
                          training["eval_forwards"])
    emit({"phase": "training", "config": str(EXAMPLE.relative_to(REPO)),
          "draft_config": str(CONFIG.relative_to(REPO)), "batch": BATCH,
          "max_length": MAX_LEN, "ttt_length": TTT,
          "accumulation_steps": ACCUM, "launches": counts,
          "tolerances": {"step1_loss_rtol": TRAIN_STEP1_RTOL,
                         "later_loss_rtol": TRAIN_DRIFT_RTOL,
                         "grad_cosine": GRAD_COSINE,
                         "grad_norm_rtol": GRAD_NORM_RTOL},
          **training})
    for k in kernels:
        k["launches"] = counts[k["name"]]
        k["kernel_ms"] = k["ms"]
    emit({"kernels": kernels})
    print(smi, flush=True)
    # one card is used, whatever the machine holds
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
