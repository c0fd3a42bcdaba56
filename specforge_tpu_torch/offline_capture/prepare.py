"""Offline feature capture over a dataset: ``python -m
specforge_tpu_torch.offline_capture.prepare``.

Counterpart of ``scripts/prepare_hidden_states.py``: runs the frozen
target's prefill (``OfflineCaptureRunner``, any family the JAX package
captures from; ``--moe-impl dense|gathered`` for an MoE target,
``gathered`` by default) over the records of a JSONL file, writes one
``.sft`` per sample in the algorithm's layout, and derives the shared vocab
mapping (``vocab_mapping.npz``) from the captured ids when the draft's
vocabulary is smaller than the target's. It runs on CUDA unless
``--device`` names another device.

The port imports no tokenizer package, so this entry point reads records
that are already tokenised (``input_ids`` with ``loss_mask``), truncated to
``--max-length``; a record with nothing supervised is dropped, as
``build_dataset`` drops one. Conversations go through the Python API:
``data.parse.build_dataset(records, tokenizer, template, max_length)`` with
any tokenizer object, then :func:`capture`.

``--shard-over-devices`` shards the target over a capture mesh of every
local card (``--shard-over-devices N``: N ranks; on the CPU, N gloo
processes): the command starts one rank process per card itself
(``parallel/multihost.py:RankProcesses``), every rank loads only its
shards and runs every batch, and rank 0 writes the files. ``--moe-impl
ep`` keeps an MoE target's experts sharded by expert
(``--moe-capacity-factor`` bounds each rank's rows; an overflow aborts).
Started with the ``SPECFORGE_*`` env already set, the command runs as the
given rank.

Usage:
    python -m specforge_tpu_torch.offline_capture.prepare \\
        --target-model /path/to/qwen3-8b --data tokenized.jsonl \\
        --output-dir features/ --algorithm eagle3 --max-length 2048 \\
        --draft-config configs/qwen3-8b-eagle3.json \\
        [--shard-over-devices [N]] [--moe-impl ep [--moe-capacity-factor F]]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

ALGORITHMS = ("eagle3", "peagle", "dflash", "domino", "dspark")


@dataclass
class CaptureResult:
    runner: "OfflineCaptureRunner"  # noqa: F821  (imported lazily)
    capture_layers: tuple
    written: List[str]
    vocab_mapping_path: Optional[str]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="specforge_tpu_torch.offline_capture.prepare")
    parser.add_argument("--target-model", required=True)
    parser.add_argument("--data", required=True,
                        help="JSONL of tokenised records (input_ids, "
                             "loss_mask)")
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--algorithm", default="eagle3", choices=ALGORITHMS)
    parser.add_argument("--max-length", type=int, default=2048)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--draft-config", help="draft config JSON (for "
                        "capture layers + draft vocab size)")
    parser.add_argument("--capture-layers", type=int, nargs="*")
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--shard-over-devices", type=int, nargs="?",
                        const=0, metavar="N",
                        help="shard the target over a capture mesh of N "
                             "ranks, one process each (alone or 0: every "
                             "local card)")
    parser.add_argument("--moe-impl", choices=("dense", "gathered", "ep"),
                        default="gathered",
                        help="how an MoE target combines its experts; ep "
                             "keeps them sharded over the mesh")
    parser.add_argument("--moe-capacity-factor", type=float,
                        help="EP: each rank's rows as a multiple of "
                             "rows/ep (default: all, never drops)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, which must exist)")
    return parser.parse_args(argv)


def read_tokenized(path: str, max_length: int, limit: int = 0
                   ) -> List[Dict[str, np.ndarray]]:
    """Tokenised records of a JSONL file, truncated to ``max_length``; a
    record with nothing supervised (or under 2 tokens) is dropped. A
    conversation record raises: it needs a tokenizer."""
    samples = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            record = json.loads(line)
            if "input_ids" not in record or "loss_mask" not in record:
                raise ValueError(
                    "this entry point reads tokenised records (input_ids, "
                    "loss_mask); tokenise conversations with "
                    "specforge_tpu_torch.data.parse.build_dataset(records, "
                    "tokenizer, template, max_length) and call capture()"
                )
            ids = np.asarray(record["input_ids"], np.int64)[:max_length]
            mask = np.asarray(record["loss_mask"], np.int64)[:max_length]
            if len(ids) != len(mask):
                raise ValueError("input_ids and loss_mask differ in length")
            if mask.sum() == 0 or len(ids) < 2:
                continue
            samples.append({"input_ids": ids, "loss_mask": mask})
            if limit and len(samples) >= limit:
                break
    return samples


def capture(
    samples: Sequence[Dict[str, np.ndarray]],
    *,
    target_model: str,
    output_dir: str,
    algorithm: str = "eagle3",
    draft_config: Optional[str] = None,
    capture_layers: Optional[Sequence[int]] = None,
    max_length: int = 2048,
    batch_size: int = 4,
    device=None,
    moe_impl: str = "gathered",
    mesh=None,
    moe_capacity_factor: Optional[float] = None,
    runner=None,
) -> CaptureResult:
    """Capture ``samples`` (``input_ids``, ``loss_mask``) into
    ``output_dir`` and derive the vocab mapping there (on a capture
    ``mesh``, rank 0 writes). ``runner``: one already holding the target's
    weights (its layers and layout must be this call's), so a second set
    of files reuses them, with its mesh and MoE settings."""
    from specforge_tpu_torch.algorithms.builtin import (
        builtin_algorithm_registry,
    )
    from specforge_tpu_torch.models.target.transformer import TargetConfig
    from specforge_tpu_torch.offline_capture.capture import (
        OfflineCaptureConfig,
        OfflineCaptureRunner,
    )
    from specforge_tpu_torch.training.vocab_mapping import (
        derive_vocab_mapping,
        save_vocab_mapping,
    )

    providers = builtin_algorithm_registry().resolve(algorithm).providers
    target_config = (runner.target_config if runner is not None
                     else TargetConfig.from_file(target_model))
    config = None
    if draft_config:
        with open(draft_config) as f:
            config = providers.draft_config(json.load(f))
    layers = tuple(providers.resolve_capture_layers(
        config, target_config.num_hidden_layers,
        tuple(capture_layers) if capture_layers else None))
    layout = "eagle" if algorithm in ("eagle3", "peagle") else "dflash"
    capture_config = OfflineCaptureConfig(
        target_model_path=target_model, output_dir=output_dir,
        capture_layers=layers, max_length=max_length, batch_size=batch_size,
        layout=layout)
    if runner is None:
        runner = OfflineCaptureRunner(capture_config,
                                      target_config=target_config,
                                      mesh=mesh, moe_impl=moe_impl,
                                      moe_capacity_factor=moe_capacity_factor,
                                      device=device)
    else:
        if (tuple(runner.config.capture_layers) != layers
                or runner.config.layout != layout):
            raise ValueError(
                f"the runner captures layers {runner.config.capture_layers} "
                f"({runner.config.layout}); this call needs {layers} "
                f"({layout})")
        runner = OfflineCaptureRunner(
            capture_config, target_config=target_config,
            target_params=runner.params, mesh=runner.mesh,
            moe_impl=runner.moe_impl,
            moe_capacity_factor=runner.moe_capacity_factor)
    written = runner.run(samples)

    mapping_path = None
    draft_vocab = getattr(config, "draft_vocab_size", None)
    if draft_vocab and draft_vocab < target_config.vocab_size:
        mapping_path = os.path.join(output_dir, "vocab_mapping.npz")
        if runner.primary:
            t2d, d2t = derive_vocab_mapping(
                (s["input_ids"] for s in samples), target_config.vocab_size,
                draft_vocab)
            save_vocab_mapping(mapping_path, t2d, d2t)
    return CaptureResult(runner=runner, capture_layers=layers,
                         written=written, vocab_mapping_path=mapping_path)


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    samples = read_tokenized(args.data, args.max_length, args.limit)
    mesh = ranks = None
    if args.shard_over_devices is not None:
        from specforge_tpu_torch.offline_capture.capture import (
            build_capture_mesh,
        )
        from specforge_tpu_torch.parallel.multihost import (
            RankProcesses,
            resolve_rank_count,
        )
        from specforge_tpu_torch.utils import resolve_device

        device = resolve_device(args.device)
        n = (0 if "SPECFORGE_COORDINATOR" in os.environ
             else resolve_rank_count(args.shard_over_devices, device))
        ranks = RankProcesses(
            "specforge_tpu_torch.offline_capture.prepare", argv, n).start()
    try:
        if ranks is not None:
            mesh = build_capture_mesh(n, device)
        primary = mesh is None or mesh.rank == 0
        if primary:
            print(f"read {len(samples)} tokenised samples")
            if mesh is not None:
                print(f"sharding the target over {mesh.world_size} ranks "
                      f"({mesh.transport})")
        result = capture(
            samples, target_model=args.target_model,
            output_dir=args.output_dir, algorithm=args.algorithm,
            draft_config=args.draft_config,
            capture_layers=args.capture_layers, max_length=args.max_length,
            batch_size=args.batch_size, device=args.device,
            moe_impl=args.moe_impl, mesh=mesh,
            moe_capacity_factor=args.moe_capacity_factor)
    except BaseException:
        if ranks is not None:
            ranks.kill()
        raise
    if ranks is not None:
        ranks.join()
    if primary:
        layout = result.runner.config.layout
        print(f"capture layers: {result.capture_layers} (layout={layout})")
        print(f"wrote {len(result.written)} feature files")
        if result.vocab_mapping_path:
            print(f"wrote vocab mapping to {result.vocab_mapping_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
