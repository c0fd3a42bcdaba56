#!/usr/bin/env python3
"""Time one family of attention kernels of several checkouts on one card, in turns.

Usage, from the repository root on a machine with a card::

    mkdir -p chip_trees/parent
    git archive <parent commit> | tar -x -C chip_trees/parent
    python3 kernel_compare.py chip_trees/parent . . chip_trees/parent \\
        [--family ttt|dflash|cod|lse] [--micro-step]
    python3 kernel_compare.py chip_trees/parent . --sass

For each TREE (a checkout of this repository; ``chip_trees/`` is listed in
``.gitignore``), in the order given, one process imports that tree's port,
builds its kernel library and prints one JSON line with the family's three
kernels timed at the shape of its main path, each through that tree's own
``chip_smoke`` helpers and wrappers:

- ``ttt`` (the default): the EAGLE3 shape of ``chip_smoke.py`` (B=2, H=32,
  KVH=8, S=2048, D=128, padded key_valid) at each branch count 0..6 of the
  main path: the forward (``ttt_flash_attention_fwd``), the dq kernel, the
  dk/dv kernel and the whole ``ttt_flash_attention_bwd`` (delta, the kernels
  and any reduction), and their means over the branch counts;
- ``dflash``: case (a) of ``chip_smoke.DFLASH_CASES``, the Domino slice
  (B=2, H=32, KVH=8, D=128, S=768, 256 anchors of 16, from
  ``dflash_case_inputs``; the block size is the case's last field, or
  ``DFLASH_BS`` in a tree whose cases lack it): the forward, dq (with the
  draft keys' dk/dv), the context keys' dk/dv and the whole
  ``dflash_flash_attention_bwd``
  (delta, both kernels and any reduction: a tree whose dq kernel leaves
  the draft dk/dv per query head sums them there);
- ``cod``: case (a) of ``chip_smoke.COD_CASES``, the P-EAGLE slice (B=2,
  H=32, KVH=8, D=128, S=1024 over 8 depths, from ``cod_case_inputs``): the
  forward, dq, dk/dv and the whole ``cod_attention_bwd``;
- ``lse``: the USP ring hop, cases ``a_own`` and ``b_earlier`` of
  ``chip_smoke.LSE_CASES`` (BH=16, S=4096, D=128: the own chunk and an
  earlier one) and the hops of ``LSE_MAIN_PATH`` (S=2048: two own, one
  earlier, one later), from ``lse_case_inputs``: the forward, dq, dk/dv
  and the whole ``lse_attention_bwd`` (dstat, both kernels), each case on
  its own and as the main path's mean (``main_<kernel>_ms``). It has no
  ``--micro-step``: its micro-step is the USP phase, ``chip_smoke.py
  --usp-only`` on four cards, run per tree in turn.

Each kernel is timed twice with CUDA events: ``<kernel>_ms``, one launch at
a time (``chip_smoke.median_ms``: median of 20 after 3 warm-ups, a sync
after each launch, so the wrapper's host work before the launch counts) and
``<kernel>_run_ms``, 30 launches back to back between two events after 3
warm-ups (the kernel as a step runs it). With ``--micro-step`` it also times
the family's micro-step at Qwen3-8B width, random weights from seed 0 and
the ``chip_smoke`` training run's data (EAGLE3
``configs/qwen3-8b-eagle3.json``; Domino ``configs/qwen3-8b-domino.json``;
P-EAGLE ``configs/qwen3-8b-peagle.json``): the trainer's own
``micro_step``, host clock to a device sync, median of 7 after one. Give
the trees in turns (parent, change, change, parent): the card drifts
between runs. The first line is the card's name and power limit; any
failure exits non-zero.

With ``--sass`` it times nothing: each tree's kernel sources
(``cuda_lib.SOURCES``) are compiled to cubins with that tree's flags and
``cuobjdump -sass`` prints each kernel's machine code, which is compared
across the trees with the constant-bank offsets of the parameters masked
(a changed parameter struct moves them): one line per tree with a digest
per kernel and head dim (``<128>``; a build with a bool template flag set,
the DFlash kernels' pitched builds, ``<128, true>``; the flag cleared
keeps the name ``<128>``), then one line naming the kernels whose code
differs between the first tree and each other.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

WORKER = r'''
import json, statistics, sys, tempfile, time
from pathlib import Path
import torch
import chip_smoke as cs
from specforge_tpu_torch.ops import attention_cuda as ac, cuda_lib

opts = json.loads(sys.argv[1])
cuda_lib.library()
gen = torch.Generator(device="cuda").manual_seed(0)


def run_ms(fn, launches=30, warmup=3):
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


def timed(kernels):
    row = {}
    for name, fn in kernels.items():
        row[name + "_ms"] = cs.median_ms(fn)
        row[name + "_run_ms"] = run_ms(fn)
    return row


def randn_like(x):
    return torch.randn(x.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def ttt():
    rows = []
    for nb in range(cs.TTT):
        q, keys, values, key_valid = cs.attention_inputs(gen, cs.MAX_LEN, nb,
                                                         True)
        out, m, l = ac.ttt_flash_attention_fwd(q, keys, values, key_valid)
        dout = randn_like(out)
        valid = key_valid.to(torch.int32)
        delta = ac.backward_delta(out, dout, q.shape[1])
        args = (q, keys, values, valid, dout, m, l, delta)
        row = {"branches": nb, **timed({
            "fwd": lambda: ac.ttt_flash_attention_fwd(q, keys, values,
                                                      key_valid),
            "dq": lambda: ac.ttt_attention_bwd_dq(*args),
            "dkv": lambda: ac.ttt_attention_bwd_dkv(*args),
            "bwd": lambda: ac.ttt_flash_attention_bwd(
                q, keys, values, key_valid, out, m, l, dout),
        })}
        rows.append(row)
        del q, keys, values, out, dout, args
    result = {"rows": rows}
    for key in rows[0]:
        if key.endswith("ms"):
            result["mean_" + key] = sum(r[key] for r in rows) / len(rows)
    return result


def dflash():
    from specforge_tpu_torch.ops import dflash_attention_cuda as dc
    # a tree's cases may end in their block size, else DFLASH_BS holds it
    case = cs.DFLASH_CASES[0]
    name, b, h, kvh, d, s, n, window = case[:8]
    inputs = cs.dflash_case_inputs(gen, b, h, kvh, d, s, n, *case[8:])
    bs = case[8] if len(case) > 8 else cs.DFLASH_BS
    out, m, l = dc.dflash_flash_attention_fwd(*inputs, bs, window)
    dout = randn_like(out)
    args = (*inputs, bs, window, dout, m, l, ac.backward_delta(out, dout, h))
    return {"case": name, **timed({
        "fwd": lambda: dc.dflash_flash_attention_fwd(*inputs, bs, window),
        "dq": lambda: dc.dflash_attention_bwd_dq(*args),
        "dkv": lambda: dc.dflash_attention_bwd_dkv(*args),
        "bwd": lambda: dc.dflash_flash_attention_bwd(
            *inputs, bs, window, out, m, l, dout),
    })}


def cod():
    from specforge_tpu_torch.ops import peagle_attention_cuda as pac
    name, b, h, kvh, d, s, docs, unsupervised = cs.COD_CASES[0]
    q, k, v, tiles = cs.cod_case_inputs(gen, b, h, kvh, d, s, docs,
                                        unsupervised)
    out, m, l = pac.cod_attention_fwd(q, k, v, tiles)
    dout = randn_like(out)
    args = (q, k, v, tiles, dout, m, l, ac.backward_delta(out, dout, h))
    return {"case": name, **timed({
        "fwd": lambda: pac.cod_attention_fwd(q, k, v, tiles),
        "dq": lambda: pac.cod_attention_bwd_dq(*args),
        "dkv": lambda: pac.cod_attention_bwd_dkv(*args),
        "bwd": lambda: pac.cod_attention_bwd(q, k, v, tiles, out, m, l, dout),
    })}


def lse():
    from specforge_tpu_torch.ops import lse_attention_cuda as lac
    wanted = ("a_own", "b_earlier") + tuple(cs.LSE_MAIN_PATH)
    cases = {}
    for name, bh, s, d, row_off, col_off, pad in cs.LSE_CASES:
        if name not in wanted:
            continue
        q, k, v, valid = cs.lse_case_inputs(gen, bh, s, d, pad)
        out, lse_ = lac.lse_attention_fwd(q, k, v, valid, row_off, col_off)
        dout = randn_like(out)
        dlse = torch.randn(lse_.shape, generator=gen, device="cuda")
        args = (q, k, v, valid, row_off, col_off, dout, lse_,
                lac.backward_dstat(out, dout, dlse))
        cases[name] = timed({
            "fwd": lambda: lac.lse_attention_fwd(q, k, v, valid, row_off,
                                                 col_off),
            "dq": lambda: lac.lse_attention_bwd_dq(*args),
            "dkv": lambda: lac.lse_attention_bwd_dkv(*args),
            "bwd": lambda: lac.lse_attention_bwd(q, k, v, valid, row_off,
                                                 col_off, out, lse_, dout,
                                                 dlse),
        })
        del q, k, v, valid, out, lse_, dout, dlse, args
        torch.cuda.empty_cache()
    main = [cases[name] for name in cs.LSE_MAIN_PATH]
    result = {"cases": cases}
    for key in main[0]:
        result["main_" + key] = sum(r[key] for r in main) / len(main)
    return result


def trainer_for(family, work):
    """A kernel-path trainer of the family's chip_smoke training run."""
    device = torch.device("cuda")
    if family == "ttt":
        cfg = cs.Eagle3Config.from_file(cs.CONFIG)
        cs.write_features(work / "train", cfg, 0, cs.TRAIN_FILES, 1536,
                          cs.MAX_LEN)
        cs.write_features(work / "eval", cfg, 100, cs.EVAL_FILES, 1536,
                          cs.MAX_LEN)
        target = cs.write_target_dir(work / "target", cfg.vocab_size,
                                     cfg.resolved_target_hidden_size, device,
                                     0, 0.02)
        run_json = cs.training_run_json(work, cs.CONFIG, target, cs.MAX_LEN)
    elif family == "dflash":
        from specforge_tpu_torch.models.draft.dflash import DFlashConfig
        cfg = DFlashConfig.from_dict(json.loads(cs.DOMINO_CONFIG.read_text()))
        cs.write_dflash_features(
            work / "train", len(cfg.resolved_target_layer_ids),
            cfg.hidden_size, cfg.vocab_size, 0, cs.FAMILY_FILES["domino"],
            512, 768)
        target = cs.write_target_dir(work / "target", cfg.vocab_size,
                                     cfg.hidden_size, device, 0, 0.02)
        run_json = cs.family_run_json("domino", work, cs.DOMINO_CONFIG,
                                      target, 768)
    else:
        cfg = cs.PEagleConfig.from_dict(
            json.loads(cs.PEAGLE_CONFIG.read_text()))
        cs.write_features(work / "train", cfg, 0, cs.PEAGLE_FILES, 768, 1024,
                          response_only=True)
        target = cs.write_target_dir(work / "target", cfg.vocab_size,
                                     cfg.resolved_target_hidden_size, device,
                                     0, 0.02)
        run_json = cs.peagle_run_json(work, cs.PEAGLE_CONFIG, target, 1024)
    config = cs.load_config(str(run_json), ['run_id="timing"',
                                            "training.save_interval=0"])
    return cs.build_training_run(config, device=None)


family = opts["family"]
result = {"tree": opts["tree"], "family": family,
          **{"ttt": ttt, "dflash": dflash, "cod": cod, "lse": lse}[family]()}
if opts["micro_step"]:
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="kernel-compare-") as tmp:
        trainer = trainer_for(family, Path(tmp))
        window = cs.first_window(trainer)
        step = trainer.train_step
        times = []
        for tensors in window * 4:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads, _ = step.micro_step(trainer.state, tensors,
                                       trainer.frozen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del grads
    result["micro_step_ms"] = statistics.median(times[1:])
    result["micro_step_ms_all"] = times
print(json.dumps(result), flush=True)
'''


SASS_WORKER = r'''
import hashlib, json, re, subprocess, sys, tempfile
from pathlib import Path
from specforge_tpu_torch.ops import cuda_lib

nvcc = cuda_lib.nvcc_path()
cuobjdump = str(Path(nvcc).parent / "cuobjdump")
flags, it = [], iter(cuda_lib.NVCC_FLAGS)
for flag in it:  # the compile flags, without the shared-library pairs
    if flag in ("-Xcompiler", "-Xptxas"):
        next(it)
    else:
        flags.append(flag)
digests = {}
with tempfile.TemporaryDirectory(prefix="kernel-sass-") as tmp:
    for src in cuda_lib.SOURCES:
        cubin = Path(tmp) / (src + ".cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin),
                        str(cuda_lib.CSRC_DIR / src)], check=True)
        text = subprocess.run([cuobjdump, "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout
        for part in re.split(r"\n\s*Function : ", text)[1:]:
            name, _, body = part.partition("\n")
            key = name.strip()
            # mangled: the length, then the name (a hash's digits may run
            # into the length)
            for run in re.finditer(r"\d+", name):
                for i in range(run.start(), run.end()):
                    ident = name[run.end():run.end() + int(name[i:run.end()])]
                    if re.fullmatch(r"[a-z][a-z_]*_kernel", ident):
                        args = re.match(r"ILi(\d+)E(Lb([01])E)?",
                                        name[run.end() + len(ident):])
                        # a bool template flag set names its build (the
                        # DFlash kernels' kPitched); cleared, it is the
                        # build without it
                        key = f"{ident}<{args.group(1) if args else ''}"
                        pitched = args and args.group(3) == "1"
                        key += ", true>" if pitched else ">"
                        break
                if key != name.strip():
                    break
            code = []
            for line in body.splitlines():
                ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "",
                             line)
                ins = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]", ins)
                if ins.strip():
                    code.append(" ".join(ins.split()))
            digests[key] = hashlib.sha256(
                "\n".join(code).encode()).hexdigest()[:16]
print(json.dumps({"tree": sys.argv[1], "sass": digests}), flush=True)
'''


def compare_sass(trees) -> int:
    """Each tree's kernel digests, then the kernels whose code differs."""
    rows = []
    for tree in trees:
        root = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, "-c", SASS_WORKER, tree],
                              cwd=root, env=dict(os.environ, PYTHONPATH=root),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip(), flush=True)
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    first = rows[0]["sass"]
    for row in rows[1:]:
        other = row["sass"]
        print(json.dumps({
            "sass_vs": [rows[0]["tree"], row["tree"]],
            "same": sorted(k for k in first if other.get(k) == first[k]),
            "differ": sorted(k for k in first
                             if k in other and other[k] != first[k]),
            "only_first": sorted(k for k in first if k not in other),
            "only_other": sorted(k for k in other if k not in first),
        }), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", help="checkouts, in turn order")
    parser.add_argument("--family", choices=("ttt", "dflash", "cod", "lse"),
                        default="ttt", help="the kernels to time")
    parser.add_argument("--micro-step", action="store_true",
                        help="also time the family's micro-step of each tree")
    parser.add_argument("--sass", action="store_true",
                        help="compare the trees' kernel machine code instead")
    args = parser.parse_args()
    if args.family == "lse" and args.micro_step:
        parser.error("the LSE micro-step is the USP phase: run chip_smoke.py "
                     "--usp-only per tree on four cards")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi.splitlines()[0]}), flush=True)
    if args.sass:
        return compare_sass(args.trees)
    for tree in args.trees:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        opts = json.dumps({"tree": tree, "family": args.family,
                           "micro_step": args.micro_step})
        proc = subprocess.run([sys.executable, "-c", WORKER, opts], cwd=root,
                              env=env)
        if proc.returncode != 0:
            print(f"{tree}: exited {proc.returncode}", file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
