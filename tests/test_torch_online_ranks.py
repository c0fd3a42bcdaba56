"""The port's online topology in processes of its own, on the CPU: the
managed stack through ``cli train --managed-local --device cpu`` (the
store built from ``cpp/feature_store_server.cpp``, the port's capture
server, producer and consumer); a producer and a consumer killed and
restarted (no sample trained twice; ``tests/test_recovery.py``); and a
two-rank consumer over gloo, on a shared control directory and over rank
0's HTTP inbox relay. Every process has its own timeout."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from specforge_tpu_torch.application.disaggregated import run_producer
from specforge_tpu_torch.config.schema import Config
from specforge_tpu_torch.inference.capture_server import (
    CaptureEngine,
    CaptureServer,
)
from specforge_tpu_torch.runtime.control_plane.metadata_store import (
    SQLiteMetadataStore,
)
from specforge_tpu_torch.runtime.data_plane.network_store import server_path
from specforge_tpu_torch.runtime.data_plane.streaming_ref_channel import (
    StreamingRefChannel,
)
from tests._torch_online import (
    LAYERS,
    MAXLEN,
    REPO,
    env_for,
    free_port,
    json_blocks,
    metric_steps,
    payload,
    start_store,
    store_objects,
    write_prompts,
)
from tests.test_torch_capture import save_target

#: seconds a process of these tests may run (a rank: the join limit)
PROCESS_TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per test worker (see test_torch_train.py's
    fixture of the same name: the default oversubscribes a shared CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def target(tmp_path_factory):
    return save_target(tmp_path_factory.mktemp("target"), "llama")


@pytest.fixture()
def stack(target):
    store_proc, endpoint = start_store()
    server = CaptureServer(CaptureEngine(target, capture_layers=LAYERS,
                                         max_length=MAXLEN,
                                         device="cpu")).start()
    try:
        yield target, endpoint, f"http://127.0.0.1:{server.port}"
    finally:
        server.stop()
        store_proc.terminate()
        store_proc.wait(timeout=10)


def cli(config_path, *args, env=None, **popen):
    return subprocess.Popen(
        [sys.executable, "-m", "specforge_tpu_torch.cli", "train", "-c",
         str(config_path), *args],
        cwd=REPO, env=env or env_for(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, **popen)


def finish(proc, timeout=PROCESS_TIMEOUT) -> str:
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        pytest.fail(f"a process ran past {timeout} s:\n{out[-3000:]}")
    assert proc.returncode == 0, out[-4000:]
    return out


def kill(proc) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate(timeout=30)


def wait_for(predicate, what, timeout=PROCESS_TIMEOUT, proc=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        if proc is not None and proc.poll() is not None:
            out = proc.communicate()[0]
            pytest.fail(f"the process exited before {what}:\n{out[-3000:]}")
        time.sleep(0.1)
    pytest.fail(f"no {what} within {timeout} s")


def write_config(tmp_path, raw, name="run.json"):
    path = tmp_path / name
    path.write_text(json.dumps(raw))
    return path


def ledger(tmp_path, run_id):
    store = SQLiteMetadataStore(str(tmp_path / "runs" / run_id
                                    / "consumer_state" / "consumer.sqlite"))
    try:
        return store.acked_ids(), store.durable_step()
    finally:
        store.close()


def inbox_ids(tmp_path, run_id, generation, rank=0):
    path = (tmp_path / "runs" / run_id / "consumer_state"
            / f"inboxes-g{generation}" / f"rank{rank}.jsonl")
    return [r["sample_id"] for r in map(json.loads, open(path))
            if r.get("kind") == "ref"]


def test_managed_local_cli_runs_the_whole_topology(target, tmp_path):
    """``cli train --managed-local --device cpu`` (role auto): the store
    server built into ``specforge_tpu_torch/_build/``, the port's capture
    server, the producer and the consumer, each its own process."""
    write_prompts(tmp_path / "prompts.jsonl", 8)
    server_url = f"http://127.0.0.1:{free_port()}"
    raw = payload(tmp_path, "managed", target, f"127.0.0.1:{free_port()}",
                  server_url, tmp_path / "prompts.jsonl", role="auto")
    raw["deployment"]["managed_local"] = {
        "capture_layers": list(LAYERS), "capture_max_length": MAXLEN,
        "readiness_timeout_s": 120, "shutdown_grace_s": 10}
    path = write_config(tmp_path, raw)
    out = finish(cli(path, "--managed-local", "--device", "cpu",
                     "--set", "training.total_steps=4"))
    printed = json_blocks(out)
    plan = next(b for b in printed if "commands" in b)
    assert plan["kind"] == "managed_supervisor"
    assert [c["name"] for c in plan["commands"]] == [
        "feature_store", "capture_server_0", "producer", "consumer"]
    assert plan["commands"][0]["argv"][0] == str(server_path())
    assert server_path().exists()
    # the overrides reach the children through the resolved copy
    assert plan["commands"][2]["argv"][5].endswith("managed.launch.json")
    server = next(b for b in printed if "capture_server" in b)
    assert server["device"] == "cpu" and server["layers"] == list(LAYERS)
    assert next(b for b in printed if "samples_produced" in b)[
        "samples_produced"] == 8
    consumer = next(b for b in printed if "store/objects" in b)
    assert consumer["store/objects"] == 0 and np.isfinite(
        consumer["train/loss"])
    assert [r["step"] for r in metric_steps(
        tmp_path / "runs" / "managed.metrics.jsonl")] == [1, 2, 3, 4]


def test_producer_and_consumer_killed_and_restarted(stack, tmp_path):
    """A producer killed after 6 of 16 samples and a consumer killed
    after 3 steps (checkpoint and acks at step 2), both restarted: the
    producer publishes the other 10 once, the consumer resumes from step 2
    with the 2 unacked samples first, and the run ends at step 8 with every
    sample trained once after the restored state and released."""
    target, endpoint, url = stack
    n = 16
    write_prompts(tmp_path / "prompts.jsonl", n)
    raw = payload(tmp_path, "rec", target, endpoint, url,
                  tmp_path / "prompts.jsonl", total_steps=8,
                  save_interval=2, resume=True)
    path = write_config(tmp_path, raw)
    # the first producer pauses once 6 refs are in flight (nobody consumes
    # yet), in rounds of 2: so it is killed at a known point
    first_raw = json.loads(json.dumps(raw))
    first_raw["runtime"].update(capture_batch_size=2, flow_high_watermark=6,
                                flow_low_watermark=2)
    control = raw["runtime"]["control_dir"]

    def published():
        return len(StreamingRefChannel(control).poll()[0])

    producer = cli(write_config(tmp_path, first_raw, "first.json"),
                   start_new_session=True)
    try:
        wait_for(lambda: published() >= 6, "6 published refs", proc=producer)
        time.sleep(1.0)
        assert published() == 6
    finally:
        kill(producer)
    consumer = cli(path, "--set", 'training.role="consumer"', "--device",
                   "cpu", start_new_session=True)
    metrics = tmp_path / "runs" / "rec.metrics.jsonl"
    try:
        wait_for(lambda: metrics.exists() and len(metric_steps(metrics)) >= 3,
                 "step 3", proc=consumer)
        time.sleep(1.0)  # the stream is open: it waits for more
    finally:
        kill(consumer)
    acked, durable = ledger(tmp_path, "rec")
    assert durable == 2 and len(acked) == 4  # acks ran no ahead of step 2
    first = inbox_ids(tmp_path, "rec", 0)
    assert len(first) == 6

    config = Config.model_validate(raw)
    assert run_producer(config) == n - 6  # the 6 published are skipped
    refs, closed, _ = StreamingRefChannel(control).poll()
    assert closed and len({r.sample_id for r in refs}) == len(refs) == n
    out = finish(cli(path, "--set", 'training.role="consumer"', "--device",
                     "cpu"))
    assert "resumed rec at step 2" in out
    again = inbox_ids(tmp_path, "rec", 2)
    # the unacked tail of the first run first, then the new samples
    assert again[:2] == first[4:6] and len(again) == n - 4
    assert set(first[:4]).isdisjoint(again)
    assert set(first[:4]) | set(again) == {r.sample_id for r in refs}
    acked, durable = ledger(tmp_path, "rec")
    assert durable == 8 and len(acked) == n
    contract = json.loads((tmp_path / "runs" / "rec-step8"
                           / "contract.json").read_text())
    assert contract["progress"]["global_step"] == 8
    steps = [r["step"] for r in metric_steps(metrics)]
    assert steps == [1, 2, 3, 3, 4, 5, 6, 7, 8]  # step 3 again, restored
    assert store_objects(endpoint) == 0


@pytest.mark.parametrize("mode", ["shared_dir", "http_relay"])
def test_two_rank_consumer(stack, tmp_path, mode):
    """Two gloo ranks (dp 1 × fsdp 2) consume one stream: rank 0 alone
    reads the channel into per-rank inboxes; rank 1 reads its inbox from
    the shared control directory, or over rank 0's HTTP relay, where its
    acks go too. The same losses on both ranks, every sample acked once
    and released."""
    target, endpoint, url = stack
    n = 8
    write_prompts(tmp_path / "prompts.jsonl", n)
    raw = payload(tmp_path, mode, target, endpoint, url,
                  tmp_path / "prompts.jsonl", role="consumer",
                  save_interval=2)
    if mode == "http_relay":
        relay = free_port()
        raw["runtime"].update(inbox_server_port=relay,
                              inbox_server_url=f"http://127.0.0.1:{relay}")
    path = write_config(tmp_path, raw)
    assert run_producer(Config.model_validate(raw)) == n
    coordinator = f"localhost:{free_port()}"
    ranks = [cli(path, "--device", "cpu",
                 env=env_for(rank, 2, coordinator)) for rank in (0, 1)]
    outs = [finish(p) for p in ranks]
    finals = [next(b for b in json_blocks(out) if "train/loss" in b)
              for out in outs]
    assert finals[0]["train/loss"] == finals[1]["train/loss"]
    assert np.isfinite(finals[0]["train/loss"])
    acked, durable = ledger(tmp_path, mode)
    assert len(acked) == n and durable == 4
    assert sorted(inbox_ids(tmp_path, mode, 0, 0)
                  + inbox_ids(tmp_path, mode, 0, 1)) == sorted(acked)
    assert store_objects(endpoint) == 0
    assert [r["step"] for r in metric_steps(
        tmp_path / "runs" / f"{mode}.metrics.jsonl")] == [1, 2, 3, 4]
