#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA GPU (H100).

Usage: ``python3 chip_smoke.py [--seed N]`` from the repository root.

Phases, each printing JSON lines:

1. device facts: torch/CUDA versions, ``nvidia-smi`` name and power limit,
   the ``nvcc`` version;
2. build: every kernel source of ``specforge_tpu_torch/csrc`` compiled by
   ``nvcc`` for ``sm_90a`` (in parallel) into one library;
3. kernels, at the shapes of the slice: each kernel is held against its
   plain PyTorch version on the card, in the working dtype, and timed with
   CUDA events (median of 20 runs after warm-up) beside the plain version,
   one PyTorch library call as a yardstick, and its bound;
4. slice: the EAGLE3 offline TTT forward at the full Qwen3-8B EAGLE3 width
   (``configs/qwen3-8b-eagle3.json``, random weights from ``--seed``), from
   feature files written and read back by the port's data plane, through
   ``Evaluator.run`` and ``Eagle3TrainStrategy.forward_loss`` with the
   compact teacher; the kernel launch counters must show 7 launches of each
   kernel per forward, and the metrics must agree with the same batches run
   through the plain dense attention and reference CE on the card;
5. the kernels line, then the card line, then ``{"ok": true, ...}``.

Any failed check raises: the script then exits non-zero with a traceback and
prints no result. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from specforge_tpu_torch.algorithms.eagle3.model import OnlineEagle3Model
from specforge_tpu_torch.data.collator import CollatorConfig, PaddingCollator
from specforge_tpu_torch.eval.evaluator import Evaluator
from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    LlamaEagle3Draft,
)
from specforge_tpu_torch.ops import attention_cuda, cuda_lib, loss_cuda
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
from specforge_tpu_torch.training.strategies import Eagle3TrainStrategy
from specforge_tpu_torch.training.vocab_mapping import (
    load_vocab_mapping,
    save_vocab_mapping,
)

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs" / "qwen3-8b-eagle3.json"

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


def attention_bound_ms(q, keys, key_valid) -> tuple:
    """Least time for the same work: each input read once, each output
    written once; the FLOPs of the allowed (row, key) pairs of these inputs."""
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
    t_bytes, t_ops = nbytes / PEAK_HBM, flops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else
                                        "operations")


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
            row["bound_ms"], row["bound_by"] = attention_bound_ms(
                q, keys, key_valid)
            timed.append(row)
        emit(row)
        del q, keys, values, ref_out, out
    n = len(timed)
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
        "bound_ms": sum(r["bound_ms"] for r in timed) / n,
        "bound_by": timed[-1]["bound_by"],
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
    """One forward_loss under torch.profiler: device time by kernel, and the
    device's idle share of the (profiled, so slower) wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            out = strategy.forward_loss(batch.tensors, frozen,
                                        metadata=metadata)
        float(out.loss)
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
    for k in kernels:
        k["launches"] = counted["launches"][k["name"]]
        k["kernel_ms"] = k["ms"]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
