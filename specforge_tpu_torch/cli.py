"""Command-line interface: ``python -m specforge_tpu_torch.cli train``.

Counterpart of ``specforge_tpu/cli.py`` for ``train``: a config file,
dotted ``--set`` overrides and the ``--plan`` dry run, offline, on CUDA
unless ``--device`` names another device. A sequence-parallel run
(``attention_backend: "usp"``) starts this command once per rank with
``SPECFORGE_COORDINATOR=host:port``, ``SPECFORGE_NUM_PROCESSES`` and
``SPECFORGE_PROCESS_ID``, as the JAX multi-host recipe does; each rank
leaves the process group it made on exit. SIGTERM unwinds as an
exception, so the trainer's cleanup runs. ``export`` and ``benchmark`` are
not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
from typing import List, Optional


class _SignalUnwind(SystemExit):
    pass


def _install_signal_unwind():
    """SIGTERM → exception so cleanup (profiler, tracker) runs."""
    def handler(signum, _frame):
        raise _SignalUnwind(128 + signum)

    signal.signal(signal.SIGTERM, handler)


def _train(args) -> int:
    from specforge_tpu_torch.config.schema import load_config

    config = load_config(args.config, args.set or [])
    if args.plan:
        print(json.dumps(config.model_dump(), indent=2, default=str))
        return 0
    _install_signal_unwind()
    import torch.distributed as dist

    from specforge_tpu_torch.application.composition import build_training_run
    from specforge_tpu_torch.parallel.multihost import shutdown

    # a process group that the caller made stays the caller's
    owned = not dist.is_initialized()
    try:
        trainer = build_training_run(config, device=args.device)
        try:
            metrics = trainer.fit()
        finally:
            trainer.tracker.finish()
    finally:
        if owned:
            shutdown()
    if metrics:
        print(json.dumps({k: float(v) for k, v in metrics.items()}, indent=2))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    parser = argparse.ArgumentParser(prog="specforge-tpu-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p_train = sub.add_parser("train", help="run a training job")
    p_train.add_argument("-c", "--config", required=True)
    p_train.add_argument(
        "--set", action="append", metavar="KEY=VALUE",
        help="dotted config override (repeatable)",
    )
    p_train.add_argument(
        "--plan", action="store_true",
        help="render the resolved config and exit",
    )
    p_train.add_argument(
        "--device", default=None,
        help="torch device to train on (default: CUDA, which must exist)",
    )
    p_train.set_defaults(func=_train)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
