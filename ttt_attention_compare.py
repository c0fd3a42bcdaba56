#!/usr/bin/env python3
"""Time the TTT attention kernels of several checkouts on one card, in turns.

Usage, from the repository root on a machine with a card::

    mkdir -p chip_trees/parent
    git archive <parent commit> | tar -x -C chip_trees/parent
    python3 ttt_attention_compare.py chip_trees/parent . . chip_trees/parent \\
        [--micro-step]

For each TREE (a checkout of this repository; ``chip_trees/`` is listed in
``.gitignore``), in the order given, one process imports that tree's port,
builds its kernel library and prints one JSON line with, at the EAGLE3 shape
of ``chip_smoke.py`` (B=2, H=32, KVH=8, S=2048, D=128, padded key_valid) and
each branch count 0..6 of the main path: the forward's time
(``ttt_flash_attention_fwd``), the dq kernel's, the dk/dv kernel's and the
whole ``ttt_flash_attention_bwd``'s (delta, the kernels and any reduction),
CUDA events, median of 20 after 3 warm-ups, each taken through that tree's
own ``chip_smoke`` helpers and wrappers, and their means over the branch
counts. ``chip_smoke.median_ms`` synchronizes after every launch, so its
times include the wrapper's host work before the launch; ``fwd_run_ms`` is
the forward timed as the card runs it in a step, 30 launches back to back
between two events, after 3 warm-ups. With ``--micro-step`` it also times the EAGLE3 micro-step at Qwen3-8B
width (``configs/qwen3-8b-eagle3.json``, random weights from seed 0, the
``chip_smoke`` training run's data): the trainer's own ``micro_step``, host
clock to a device sync, median of 7 after one. Give the trees in turns
(parent, change, change, parent): the card drifts between runs. The first
line is the card's name and power limit; any failure exits non-zero.
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
rows = []
for nb in range(cs.TTT):
    q, keys, values, key_valid = cs.attention_inputs(gen, cs.MAX_LEN, nb, True)
    out, m, l = ac.ttt_flash_attention_fwd(q, keys, values, key_valid)
    fwd = lambda: ac.ttt_flash_attention_fwd(q, keys, values, key_valid)
    fwd_ms = cs.median_ms(fwd)
    for _ in range(3):
        fwd()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(30):
        fwd()
    end.record()
    end.synchronize()
    fwd_run_ms = start.elapsed_time(end) / 30
    dout = torch.randn(out.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    valid = key_valid.to(torch.int32)
    delta = ac.backward_delta(out, dout, q.shape[1])
    args = (q, keys, values, valid, dout, m, l, delta)
    rows.append({
        "branches": nb,
        "fwd_ms": fwd_ms,
        "fwd_run_ms": fwd_run_ms,
        "dq_ms": cs.median_ms(lambda: ac.ttt_attention_bwd_dq(*args)),
        "dkv_ms": cs.median_ms(lambda: ac.ttt_attention_bwd_dkv(*args)),
        "bwd_ms": cs.median_ms(lambda: ac.ttt_flash_attention_bwd(
            q, keys, values, key_valid, out, m, l, dout)),
    })
    del q, keys, values, out, dout, args
result = {"tree": opts["tree"], "rows": rows}
for key in ("fwd_ms", "fwd_run_ms", "dq_ms", "dkv_ms", "bwd_ms"):
    result["mean_" + key] = sum(r[key] for r in rows) / len(rows)
if opts["micro_step"]:
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="ttt-attention-compare-"))
    cfg = cs.Eagle3Config.from_file(cs.CONFIG)
    cs.write_features(work / "train", cfg, 0, cs.TRAIN_FILES, 1536,
                      cs.MAX_LEN)
    cs.write_features(work / "eval", cfg, 100, cs.EVAL_FILES, 1536,
                      cs.MAX_LEN)
    target = cs.write_target_dir(work / "target", cfg.vocab_size,
                                 cfg.resolved_target_hidden_size,
                                 torch.device("cuda"), 0, 0.02)
    run_json = cs.training_run_json(work, cs.CONFIG, target, cs.MAX_LEN)
    config = cs.load_config(str(run_json), ['run_id="timing"',
                                            "training.save_interval=0"])
    trainer = cs.build_training_run(config, device=None)
    window = cs.first_window(trainer)
    step = trainer.train_step
    times = []
    for tensors in window * 4:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, _ = step.micro_step(trainer.state, tensors, trainer.frozen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del grads
    result["micro_step_ms"] = statistics.median(times[1:])
    result["micro_step_ms_all"] = times
print(json.dumps(result), flush=True)
'''


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", help="checkouts, in turn order")
    parser.add_argument("--micro-step", action="store_true",
                        help="also time the EAGLE3 micro-step of each tree")
    args = parser.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi.splitlines()[0]}), flush=True)
    for tree in args.trees:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root)
        opts = json.dumps({"tree": tree, "micro_step": args.micro_step})
        proc = subprocess.run([sys.executable, "-c", WORKER, opts], cwd=root,
                              env=env)
        if proc.returncode != 0:
            print(f"{tree}: exited {proc.returncode}", file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
