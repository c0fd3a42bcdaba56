"""Capture server entry point, as the managed supervisor starts it:

    python -m specforge_tpu_torch.inference.capture_server_main \\
        --target-model /path/to/target --port 38200 --config run.json

Counterpart of ``specforge_tpu/inference/capture_server_main.py``. The
target runs on CUDA unless ``--device`` names another device. With
``--config``, the capture layers come from the run's draft (the
algorithm's rule), the layout from its strategy and the maximum length
from ``data.max_length``. ``--shard-over-devices`` other than 1, ``--moe-impl
ep`` and ``--moe-capacity-factor`` are refused by name: the port captures
on one device (``ROADMAP.md`` Queue 1 item 7d).
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
from typing import List, Optional

from specforge_tpu_torch.models.target.transformer import EP_LATER


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
                        help="refused unless 1: the port captures on one "
                             "device")
    parser.add_argument("--moe-impl", choices=("dense", "gathered", "ep"),
                        help="how an MoE target combines its experts (ep is "
                             "refused: one device)")
    parser.add_argument("--moe-capacity-factor", type=float,
                        help="refused: an EP row budget")
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA, which must exist)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if args.shard_over_devices != 1 or args.moe_impl == "ep" or (
            args.moe_capacity_factor is not None):
        raise NotImplementedError(
            f"--shard-over-devices, --moe-impl ep and --moe-capacity-factor:"
            f" {EP_LATER}")
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

    engine = CaptureEngine(
        args.target_model, capture_layers=tuple(capture_layers),
        layout=layout, max_length=max_length,
        moe_impl=args.moe_impl, device=device)
    server = CaptureServer(engine, host=args.host, port=args.port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    server.start()
    print(json.dumps({"capture_server": f"{args.host}:{server.port}",
                      "layers": list(capture_layers), "layout": layout,
                      "device": str(engine.device)}), flush=True)
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
