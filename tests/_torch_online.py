"""Shared pieces of the online tests (``tests/test_torch_online_*.py``):
the port-built store server, a capture server on a tiny target, tokenised
prompts from a seed, and the run payload both packages' configs take."""

import json
import os
import shutil
import socket
import subprocess
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, H, MAXLEN = 128, 32, 32
LAYERS = (1, 2, 2)
TINY_DRAFT = {
    "architectures": ["LlamaEagle3Draft"], "vocab_size": V,
    "draft_vocab_size": 48, "hidden_size": H, "intermediate_size": 64,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "max_position_embeddings": 256,
}


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start_store():
    """The port's store server on a free port → (process, "host:port")."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ toolchain")
    from specforge_tpu_torch.runtime.data_plane.network_store import (
        server_binary,
    )

    port = free_port()
    proc = subprocess.Popen([str(server_binary()), "--port", str(port)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    for _ in range(200):
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            return proc, f"127.0.0.1:{port}"
        except OSError:
            time.sleep(0.05)
    proc.kill()
    pytest.fail("feature_store_server did not start")


def store_objects(endpoint: str) -> int:
    from specforge_tpu_torch.runtime.data_plane.network_store import (
        NetworkFeatureStore,
    )

    store = NetworkFeatureStore(endpoint)
    try:
        return store.health()["objects"]
    finally:
        store.close()


def write_prompts(path, n: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    records = []
    for _ in range(n):
        length = int(rng.integers(12, MAXLEN))
        records.append({
            "input_ids": rng.integers(0, V, size=length).tolist(),
            "loss_mask": (rng.random(length) > 0.3).astype(int).tolist()})
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return records


def payload(tmp_path, run_id, target, store, server_url, prompts, **training):
    """An online run's config dict (role producer; the consumer takes the
    same file)."""
    return {
        "run_id": run_id,
        "output_dir": str(tmp_path / "runs"),
        "model": {"target_model_path": target, "draft_config": TINY_DRAFT,
                  "compute_dtype": "float32"},
        "data": {"prompt_path": str(prompts), "max_length": MAXLEN,
                 "num_workers": 0},
        "training": {"strategy": "eagle3", "batch_size": 2,
                     "accumulation_steps": 1, "total_steps": 4,
                     "ttt_length": 2, "log_interval": 1,
                     "learning_rate": 1e-3, "role": "producer", **training},
        "tracking": {"backend": "jsonl"},
        "runtime": {"store_backend": "network", "store_endpoint": store,
                    "control_dir": str(tmp_path / f"control-{run_id}")},
        "deployment": {"mode": "disaggregated", "server_urls": [server_url]},
    }


def metric_steps(path) -> list:
    with open(path) as f:
        return [r for r in map(json.loads, f) if "train/loss" in r]


def json_blocks(text: str) -> list:
    """The JSON objects a process printed, on one line or over several."""
    out, block = [], None
    for line in text.splitlines():
        if block is not None:
            block.append(line)
            if line == "}":
                out.append(json.loads("\n".join(block)))
                block = None
        elif line == "{":
            block = [line]
        elif line.startswith("{") and line.endswith("}"):
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


def env_for(rank=None, world=None, coordinator=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    if rank is not None:
        env.update(SPECFORGE_COORDINATOR=coordinator,
                   SPECFORGE_NUM_PROCESSES=str(world),
                   SPECFORGE_PROCESS_ID=str(rank))
    return env
