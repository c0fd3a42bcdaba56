"""Command-line interface: ``python -m specforge_tpu_torch.cli train`` and
``export``.

Counterpart of ``specforge_tpu/cli.py`` for ``train`` and ``export``.
``train``: a config file, dotted ``--set`` overrides and the ``--plan`` dry
run, on CUDA unless ``--device`` names another device. An online run
(``deployment.mode: "disaggregated"``) dispatches on ``training.role`` as
the JAX CLI does: ``producer`` (``run_producer``: a CPU process, it joins
no process group), ``consumer`` (``run_consumer``), and ``auto``, which
supervises a producer and a consumer child; with ``--managed-local`` it
also starts the feature store server (built by ``g++`` at first use) and
the capture servers, and hands ``--device`` on to every child that
computes. The children read the run file; ``--set`` overrides given to
the supervisor reach them through a resolved copy,
``{output_dir}/{run_id}.launch.json``.
``export CHECKPOINT -o OUT --to {sglang,hf}``: a step directory, or a run
root with one run, written as a serving directory (``--draft-config`` gives
its ``config.json``, ``--vocab-mapping`` its ``t2d``/``d2t``); the HF
layout of a draft without an embedding takes the target's through the
Python API (``export_to_hf(..., embedding_source=...)``), as in the JAX
package. A sequence-parallel run
(``attention_backend: "usp"``) starts this command once per rank with
``SPECFORGE_COORDINATOR=host:port``, ``SPECFORGE_NUM_PROCESSES`` and
``SPECFORGE_PROCESS_ID``, as the JAX multi-host recipe does; each rank
leaves the process group it made on exit. SIGTERM unwinds as an
exception, so the trainer's cleanup runs. ``benchmark`` is not ported
yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import time
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
    role = config.training.role
    online = config.deployment.mode == "disaggregated"
    if online and role == "auto":
        from specforge_tpu_torch.launch_plan import (
            build_launch_plan,
            run_commands,
        )

        # the children read the run file: overrides given here go to them
        # in a resolved copy beside the run's outputs
        config_path = args.config
        if args.set:
            os.makedirs(config.output_dir, exist_ok=True)
            config_path = os.path.join(config.output_dir,
                                       f"{config.run_id}.launch.json")
            with open(config_path, "w") as f:
                json.dump(config.model_dump(), f, indent=2)
        store_binary = None
        if args.managed_local:
            from specforge_tpu_torch.runtime.data_plane.network_store import (
                server_binary,
            )

            store_binary = str(server_binary())
        plan = build_launch_plan(
            config, config_path, managed_local=args.managed_local,
            store_binary=store_binary, device=args.device)
        print(plan.render(), flush=True)
        stack = config.deployment.managed_local
        grace = (stack.shutdown_grace_s
                 if (args.managed_local and stack is not None)
                 else config.deployment.shutdown_grace_s)
        return run_commands(plan, grace_s=grace)
    if online and role == "producer":
        # a CPU process: it joins no process group and touches no card
        from specforge_tpu_torch.application.disaggregated import (
            run_producer,
        )

        t0 = time.perf_counter()
        produced = run_producer(config)
        seconds = time.perf_counter() - t0
        print(json.dumps({"samples_produced": produced, "seconds": seconds,
                          "samples_per_s": produced / max(seconds, 1e-9)}),
              flush=True)
        return 0

    import torch.distributed as dist

    from specforge_tpu_torch.parallel.multihost import shutdown

    # a process group that the caller made stays the caller's
    owned = not dist.is_initialized()
    try:
        if online and role == "consumer":
            from specforge_tpu_torch.application.disaggregated import (
                run_consumer,
            )

            metrics = run_consumer(config, device=args.device)
        else:
            from specforge_tpu_torch.application.composition import (
                build_training_run,
            )

            trainer = build_training_run(config, device=args.device)
            try:
                metrics = trainer.fit()
            finally:
                trainer.tracker.finish()
    finally:
        if owned:
            shutdown()
    if metrics:
        print(json.dumps({k: float(v) for k, v in metrics.items()}, indent=2),
              flush=True)
    return 0


def _export(args) -> int:
    from specforge_tpu_torch.export.exporter import export_checkpoint

    export_checkpoint(
        checkpoint=args.checkpoint,
        output_dir=args.output,
        fmt=args.to,
        draft_config_path=args.draft_config,
        vocab_mapping_path=args.vocab_mapping,
        device=args.device,
    )
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
        "--managed-local", action="store_true",
        help="supervise the whole local stack (feature store, capture "
             "servers, producer, consumer) of an online run",
    )
    p_train.add_argument(
        "--device", default=None,
        help="torch device to train on (default: CUDA, which must exist)",
    )
    p_train.set_defaults(func=_train)

    p_export = sub.add_parser("export", help="export a trained draft")
    p_export.add_argument("checkpoint", help="checkpoint dir or run root")
    p_export.add_argument("-o", "--output", required=True)
    p_export.add_argument("--to", choices=["hf", "sglang"], default="sglang")
    p_export.add_argument("--draft-config")
    p_export.add_argument("--vocab-mapping")
    p_export.add_argument(
        "--device", default=None,
        help="torch device for the casts (default: CUDA, which must exist)",
    )
    p_export.set_defaults(func=_export)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
