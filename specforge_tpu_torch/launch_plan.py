"""Launch planning and process supervision.

Counterpart of ``specforge_tpu/launch_plan.py``: a pure plan built from the
config (no side effects), and a supervisor that starts the plan's
processes and watches them:

- ``worker``             — this process runs its one role itself.
- ``supervisor``         — start the producer and consumer
                           ``specforge_tpu_torch.cli train`` children with
                           role overrides.
- ``managed_supervisor`` — also own the whole local stack: the C++ network
                           feature store (the binary
                           ``runtime/data_plane/network_store.server_binary``
                           builds) and the capture server(s)
                           (``specforge_tpu_torch.inference.capture_server_main``),
                           each gated by a readiness probe (tcp or http)
                           before its dependents start; teardown is
                           SIGTERM, a grace window, then SIGKILL. A capture
                           server with ``capture_shard_devices`` > 1 starts
                           its own ranks.

The consumer runs as one process a rank of its ``training.dp_size`` ×
``fsdp_size`` mesh, each with the ``SPECFORGE_*`` env of
``parallel/multihost.py`` and one coordinator.

``device``: the torch device every child that computes (capture server,
consumer) is given as ``--device``; the producer computes nothing and gets
none. Secrets go to the children in their environment only, and are
redacted in ``render()``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from specforge_tpu_torch.config.schema import Config
from specforge_tpu_torch.training.tracking import redact_config


@dataclass(frozen=True)
class Readiness:
    kind: str                 # "tcp" | "http"
    target: str               # "host:port" or URL
    timeout_s: float = 120.0


@dataclass(frozen=True)
class PlannedCommand:
    name: str
    argv: Tuple[str, ...]
    env: Tuple[Tuple[str, str], ...] = ()
    readiness: Optional[Readiness] = None
    #: supervisor keeps running when this exits 0 (services must not exit)
    expected_to_exit: bool = False


@dataclass(frozen=True)
class LaunchPlan:
    kind: str                 # "worker" | "supervisor" | "managed_supervisor"
    commands: Tuple[PlannedCommand, ...] = ()

    def render(self) -> str:
        return json.dumps(
            {
                "kind": self.kind,
                "commands": [
                    {
                        "name": c.name,
                        "argv": list(c.argv),
                        "env": dict(redact_config(dict(c.env))),
                        "readiness": (
                            None if c.readiness is None
                            else {"kind": c.readiness.kind,
                                  "target": c.readiness.target}
                        ),
                    }
                    for c in self.commands
                ],
            },
            indent=2,
        )


def _train_argv(config_path: str, role: str, extra: List[str]
                ) -> Tuple[str, ...]:
    return (
        sys.executable, "-m", "specforge_tpu_torch.cli", "train", "-c",
        config_path, "--set", f"training.role={role}", *extra,
    )


def build_launch_plan(
    config: Config,
    config_path: str,
    *,
    managed_local: bool = False,
    store_binary: Optional[str] = None,
    device: Optional[str] = None,
) -> LaunchPlan:
    """Derive the process topology from config. Pure (no spawning, no
    build): ``store_binary`` defaults to the path ``server_binary()``
    builds."""
    role = config.training.role
    online = config.deployment.mode == "disaggregated"

    if not online or role in ("all", "producer", "consumer"):
        return LaunchPlan(kind="worker")

    # role == "auto" on a disaggregated run: this process supervises
    commands: List[PlannedCommand] = []
    extra: List[str] = []

    if managed_local:
        from specforge_tpu_torch.config.schema import ManagedLocalStackConfig
        from specforge_tpu_torch.runtime.data_plane.network_store import (
            server_path,
        )

        stack = config.deployment.managed_local or ManagedLocalStackConfig()
        endpoint = config.runtime.store_endpoint or "127.0.0.1:38100"
        port = endpoint.rsplit(":", 1)[1]
        store_argv = [store_binary or str(server_path()), "--port", port]
        if stack.store_max_bytes:
            store_argv += ["--max-bytes", str(stack.store_max_bytes)]
        store_env: Tuple[Tuple[str, str], ...] = ()
        if config.runtime.store_secret:
            # via env, never argv: env is redacted by plan.render() and
            # invisible to `ps` (the server reads SPECFORGE_STORE_SECRET)
            store_env = (
                ("SPECFORGE_STORE_SECRET", config.runtime.store_secret),
            )
        commands.append(PlannedCommand(
            name="feature_store",
            argv=tuple(store_argv),
            env=store_env,
            readiness=Readiness(
                kind="tcp", target=endpoint,
                timeout_s=stack.readiness_timeout_s,
            ),
        ))
        from urllib.parse import urlsplit

        for i, url in enumerate(config.deployment.server_urls):
            server_argv = [
                sys.executable, "-m",
                "specforge_tpu_torch.inference.capture_server_main",
                "--target-model", config.model.target_model_path or "",
                "--port", str(urlsplit(url).port),
                "--config", config_path,
                "--max-length", str(stack.capture_max_length),
            ]
            if stack.capture_layers:
                server_argv += ["--capture-layers"] + [
                    str(layer) for layer in stack.capture_layers
                ]
            if stack.capture_shard_devices != 1:
                server_argv += [
                    "--shard-over-devices", str(stack.capture_shard_devices)
                ]
            if stack.capture_moe_impl:
                server_argv += ["--moe-impl", stack.capture_moe_impl]
            if stack.capture_moe_capacity_factor is not None:
                server_argv += [
                    "--moe-capacity-factor",
                    str(stack.capture_moe_capacity_factor),
                ]
            if device is not None:
                server_argv += ["--device", device]
            commands.append(PlannedCommand(
                name=f"capture_server_{i}",
                argv=tuple(server_argv),
                readiness=Readiness(
                    kind="http", target=f"{url}/health",
                    timeout_s=stack.readiness_timeout_s,
                ),
            ))

    commands.append(PlannedCommand(
        name="producer",
        argv=_train_argv(config_path, "producer", extra),
        expected_to_exit=True,  # producers drain the prompt plan and exit
    ))
    consumer_argv = _train_argv(
        config_path, "consumer",
        extra + (["--device", device] if device else []))
    # a consumer process a rank of the run's dp x fsdp mesh
    t = config.training
    consumers = t.dp_size * max(t.fsdp_size, 1)
    if consumers == 1:
        commands.append(PlannedCommand(name="consumer", argv=consumer_argv,
                                       expected_to_exit=True))
    else:  # one coordinator for the ranks, on a port free now
        from specforge_tpu_torch.parallel.multihost import free_port

        coordinator = f"localhost:{free_port()}"
        for rank in range(consumers):
            commands.append(PlannedCommand(
                name=f"consumer_{rank}", argv=consumer_argv,
                env=(("SPECFORGE_COORDINATOR", coordinator),
                     ("SPECFORGE_NUM_PROCESSES", str(consumers)),
                     ("SPECFORGE_PROCESS_ID", str(rank))),
                expected_to_exit=True))
    return LaunchPlan(
        kind="managed_supervisor" if managed_local else "supervisor",
        commands=tuple(commands),
    )


# --- supervision ------------------------------------------------------------

def _wait_ready(readiness: Readiness, proc=None) -> None:
    """Probe until ready; a process that exits first fails at once."""
    deadline = time.monotonic() + readiness.timeout_s
    last_err: Optional[Exception] = None
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(
                f"{readiness.kind}:{readiness.target}: the process exited "
                f"with {proc.returncode} before it was ready")
        try:
            if readiness.kind == "tcp":
                host, port = readiness.target.rsplit(":", 1)
                socket.create_connection((host, int(port)), timeout=2).close()
                return
            if readiness.kind == "http":
                with urllib.request.urlopen(readiness.target, timeout=2) as r:
                    if r.status == 200:
                        return
        except Exception as exc:  # noqa: BLE001 — retry until deadline
            last_err = exc
        time.sleep(0.25)
    raise TimeoutError(
        f"readiness probe {readiness.kind}:{readiness.target} timed out "
        f"({last_err})"
    )


def _terminate_processes(
    procs: List[Tuple[PlannedCommand, subprocess.Popen]],
    grace_s: float = 10.0,
) -> None:
    """SIGTERM everyone, wait out the grace window, SIGKILL stragglers
    (reference launch_plan.py:849-892)."""
    for _cmd, proc in procs:
        if proc.poll() is None:
            proc.terminate()
    deadline = time.monotonic() + grace_s
    for _cmd, proc in procs:
        remaining = max(0.0, deadline - time.monotonic())
        try:
            proc.wait(timeout=remaining)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def run_commands(
    plan: LaunchPlan,
    *,
    env: Optional[Dict[str, str]] = None,
    poll_interval: float = 0.5,
    on_spawn=None,
    grace_s: float = 10.0,
) -> int:
    """Spawn the plan and supervise: readiness-gated startup, any unexpected
    exit tears the stack down; returns the first failing exit code (0 when all
    expected-to-exit commands finish cleanly)."""
    procs: List[Tuple[PlannedCommand, subprocess.Popen]] = []
    base_env = dict(os.environ)
    base_env.update(env or {})
    exit_code = 0
    try:
        for cmd in plan.commands:
            cmd_env = dict(base_env)
            cmd_env.update(dict(cmd.env))
            proc = subprocess.Popen(list(cmd.argv), env=cmd_env)
            procs.append((cmd, proc))
            if on_spawn is not None:
                on_spawn(cmd, proc)
            if cmd.readiness is not None:
                _wait_ready(cmd.readiness, proc)

        pending = {
            cmd.name for cmd in plan.commands if cmd.expected_to_exit
        }
        while pending:
            time.sleep(poll_interval)
            for cmd, proc in procs:
                rc = proc.poll()
                if rc is None:
                    continue
                if cmd.expected_to_exit and rc == 0:
                    pending.discard(cmd.name)
                elif cmd.name in pending or not cmd.expected_to_exit:
                    # a service died or a worker failed: tear down
                    exit_code = rc or 1
                    pending.clear()
                    break
        return exit_code
    finally:
        _terminate_processes(procs, grace_s=grace_s)
