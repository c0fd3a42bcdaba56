"""CLI entry point: serve an exported draft natively.

    python -m specforge_tpu_torch.inference.serving_server_main \\
        --target <hf_target_dir> --export <export_dir> \\
        [--family eagle3|dflash] [--draft-tokens 4] [--max-len 2048] \\
        [--port 8400] [--dtype bfloat16] [--device cpu]

Counterpart of ``specforge_tpu/inference/serving_server_main.py``: loads
the target and the exported draft through the serving loaders, builds the
decoder on the card (``--device`` names another device, as the tests name
the CPU) and serves /generate and /health (``serving_server.py``): the
chain decoder for an EAGLE3 export (``--family eagle3``, the default), the
block decoder for a DFlash, Domino or DSpark SGLang export (``--family
dflash``; its block size and capture layers come from the export's
config, ``--draft-tokens`` is not read). ``--dtype`` is the target's
weight dtype (``float32`` for an exact greedy check). It prints ``READY
port=<port>`` once it listens and stops on SIGTERM or SIGINT.
``--shard-over-devices`` above 1 is refused by name (``ROADMAP.md`` Queue
1 item 8e).
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys

import torch

from specforge_tpu_torch.inference.spec_decode import (
    MESH_LATER,
    PEAGLE_LATER,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--target", required=True)
    parser.add_argument("--export", required=True)
    parser.add_argument("--family", default="eagle3",
                        choices=["eagle3", "dflash"],
                        help="dflash covers Domino and DSpark exports too "
                             "(block speculation)")
    parser.add_argument("--draft-tokens", type=int, default=4)
    parser.add_argument("--max-len", type=int, default=2048)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8400)
    parser.add_argument("--default-max-new-tokens", type=int, default=128)
    parser.add_argument("--shard-over-devices", type=int, default=0)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    if args.shard_over_devices > 1:
        parser.error(f"--shard-over-devices {args.shard_over_devices}: "
                     f"{MESH_LATER}")
    logging.basicConfig(level=logging.INFO)

    from specforge_tpu_torch.inference.serving_loaders import (
        build_decoder,
        load_spec_models,
        read_export_family,
    )
    from specforge_tpu_torch.inference.serving_server import (
        SpecServingServer,
    )

    family = read_export_family(args.export)
    if family == "peagle":
        parser.error(f"{args.export}: {PEAGLE_LATER}")
    if family != args.family:
        parser.error(f"--family {args.family}: {args.export} holds a "
                     f"{family} export")
    models = load_spec_models(args.target, args.export,
                              dtype=getattr(torch, args.dtype),
                              device=args.device)
    decoder = build_decoder(models, num_draft_tokens=args.draft_tokens,
                            max_len=args.max_len, device=args.device)
    server = SpecServingServer(
        decoder, host=args.host, port=args.port,
        default_max_new_tokens=args.default_max_new_tokens)
    server.start()
    print(f"READY port={server.port}", flush=True)

    stop = {"flag": False}

    def _sigterm(_sig, _frm):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _sigterm)
    signal.signal(signal.SIGINT, _sigterm)
    try:
        while not stop["flag"]:
            signal.pause()
    except KeyboardInterrupt:
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
