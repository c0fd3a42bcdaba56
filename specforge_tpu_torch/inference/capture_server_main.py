"""Capture server entry point, as the managed supervisor starts it:

    python -m specforge_tpu_torch.inference.capture_server_main \\
        --target-model /path/to/target --port 38200 --config run.json

Counterpart of ``specforge_tpu/inference/capture_server_main.py``. The
target runs on CUDA unless ``--device`` names another device. With
``--config``, the capture layers come from the run's draft (the
algorithm's rule), the layout from its strategy and the maximum length
from ``data.max_length``.

``--shard-over-devices N`` (0: every local card; 1: one device) shards the
target over a capture mesh of N ranks: this process is rank 0 and starts
the others itself (``parallel/multihost.py:RankProcesses``), each the same
command. Rank 0 serves HTTP once every rank has loaded its shards and
broadcasts each batch to the others; SIGTERM stops every rank, and a rank
that fails ends them all. ``--moe-impl ep`` keeps an MoE target's experts
sharded by expert, ``--moe-capacity-factor`` bounds each rank's rows (a
request whose batch overflows gets an error). Each rank prints one JSON
line with its peak memory when it stops.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="specforge_tpu_torch.inference.capture_server_main")
    parser.add_argument("--target-model", required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--config", help="run config (for capture layers)")
    parser.add_argument("--capture-layers", type=int, nargs="*")
    parser.add_argument("--layout", default="eagle",
                        choices=["eagle", "dflash"])
    parser.add_argument("--max-length", type=int, default=2048)
    parser.add_argument("--shard-over-devices", type=int, default=1,
                        metavar="N",
                        help="shard the target over a mesh of N ranks, one "
                             "process each (0: every local card; 1: one "
                             "device)")
    parser.add_argument("--moe-impl", choices=("dense", "gathered", "ep"),
                        help="how an MoE target combines its experts; ep "
                             "keeps them sharded over the mesh")
    parser.add_argument("--moe-capacity-factor", type=float,
                        help="EP: each rank's rows as a multiple of rows/ep "
                             "(default: all, never drops)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, which must exist)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    from specforge_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    capture_layers = args.capture_layers
    layout = args.layout
    max_length = args.max_length
    if args.config:
        from specforge_tpu_torch.application.composition import resolve_run
        from specforge_tpu_torch.config.schema import load_config
        from specforge_tpu_torch.models.target.transformer import (
            TargetConfig,
        )

        config = load_config(args.config)
        resolved = resolve_run(config)
        providers = resolved.registration.providers
        draft_config = providers.draft_config(resolved.draft_config_dict)
        target_config = TargetConfig.from_file(args.target_model)
        capture_layers = capture_layers or list(
            providers.resolve_capture_layers(
                draft_config, target_config.num_hidden_layers,
                tuple(config.model.aux_hidden_state_layer_ids)
                if config.model.aux_hidden_state_layer_ids else None))
        layout = ("eagle" if config.training.strategy in ("eagle3", "peagle")
                  else "dflash")
        max_length = config.data.max_length
    if not capture_layers:
        raise SystemExit("--capture-layers or --config is required")

    from specforge_tpu_torch.inference.capture_server import (
        CaptureEngine,
        CaptureServer,
    )

    mesh = ranks = None
    if args.shard_over_devices != 1:
        from specforge_tpu_torch.parallel.multihost import (
            RankProcesses,
            resolve_rank_count,
        )

        n = (0 if "SPECFORGE_COORDINATOR" in os.environ
             else resolve_rank_count(args.shard_over_devices, device))
        ranks = RankProcesses(
            "specforge_tpu_torch.inference.capture_server_main", argv,
            n).start()
    stop = threading.Event()
    try:
        if ranks is not None:
            from specforge_tpu_torch.offline_capture.capture import (
                build_capture_mesh,
            )
            from specforge_tpu_torch.parallel import multihost

            mesh = build_capture_mesh(n, device)
        engine = CaptureEngine(
            args.target_model, capture_layers=tuple(capture_layers),
            layout=layout, max_length=max_length, mesh=mesh,
            moe_impl=args.moe_impl,
            moe_capacity_factor=args.moe_capacity_factor, device=device)
        if mesh is not None:
            multihost.barrier("every rank loaded its shards")
        if engine.primary:
            engine.on_fatal = stop.set
            server = CaptureServer(engine, host=args.host, port=args.port)
            signal.signal(signal.SIGTERM, lambda *_: stop.set())
            signal.signal(signal.SIGINT, lambda *_: stop.set())
            server.start()
            print(json.dumps({
                "capture_server": f"{args.host}:{server.port}",
                "layers": list(capture_layers), "layout": layout,
                "device": str(engine.device),
                "ranks": 1 if mesh is None else mesh.world_size}),
                flush=True)
            stop.wait()
            server.stop()
            engine.stop_followers()
        else:
            engine.follow()
    except BaseException:
        if ranks is not None:
            ranks.kill()
        raise
    if ranks is not None and engine.fatal is None:
        ranks.join()
    print(json.dumps({"capture_rank": 0 if mesh is None else mesh.rank,
                      "max_memory_allocated": _peak_bytes(engine.device)}),
          flush=True)
    if engine.fatal is not None:
        if ranks is not None:
            ranks.kill()
        return 1
    return 0


def _peak_bytes(device) -> Optional[int]:
    import torch

    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device)


if __name__ == "__main__":
    raise SystemExit(main())
