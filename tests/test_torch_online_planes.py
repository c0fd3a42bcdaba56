"""The port's control plane and streaming data plane against the JAX
package's, on the CPU.

Each case of ``tests/test_runtime_planes.py`` runs as one body against
both packages' modules (``pkg``), with the same expected results; then the
state one package writes (a channel file, an inbox directory, a SQLite
ledger) is read by the other, both ways. The network store's objects cross
over in ``tests/test_torch_online_store.py``."""

import importlib
import multiprocessing
import threading
import types

import numpy as np
import pytest
import torch

MODULES = {
    "contracts": "runtime.contracts",
    "controller": "runtime.control_plane.controller",
    "flow_control": "runtime.control_plane.flow_control",
    "metadata_store": "runtime.control_plane.metadata_store",
    "dp_ack": "runtime.control_plane.dp_ack",
    "channel": "runtime.data_plane.streaming_ref_channel",
    "distributor": "runtime.data_plane.ref_distributor",
    "sample_ref_queue": "runtime.data_plane.sample_ref_queue",
    "feature_store": "runtime.data_plane.feature_store",
    "capture": "inference.capture",
    "rollout_worker": "inference.rollout_worker",
}
PACKAGES = {"jax": "specforge_tpu", "torch": "specforge_tpu_torch"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread per test worker (see test_torch_train.py's
    fixture of the same name: the default oversubscribes a shared CPU)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def modules(name: str) -> types.SimpleNamespace:
    root = PACKAGES[name]
    return types.SimpleNamespace(**{
        key: importlib.import_module(f"{root}.{path}")
        for key, path in MODULES.items()})


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return modules(request.param)


def ref(m, i):
    c = m.contracts
    return c.SampleRef(sample_id=f"s{i}", features={"x": c.FeatureHandle(
        uri=f"mem://s{i}/x.g0",
        spec=c.FeatureSpec(name="x", shape=(4,), dtype="float32"))})


def test_sqlite_store_cross_connection(pkg, tmp_path):
    path = str(tmp_path / "ledger.sqlite")
    a = pkg.metadata_store.SQLiteMetadataStore(path)
    assert a.commit_sample(ref(pkg, 0))
    assert not a.commit_sample(ref(pkg, 0))  # dedup
    a.record_ack(["s0"], global_step=3)
    b = pkg.metadata_store.SQLiteMetadataStore(path)  # a second process
    assert b.is_committed("s0")
    assert b.acked_ids() == {"s0"}
    assert b.durable_step() == 3
    assert not b.commit_sample(ref(pkg, 0))
    a.record_ack(["s1"], global_step=2)  # the marker never goes back
    assert b.durable_step() == 3
    assert [r.sample_id for r in b.committed_refs_by_ids(["s0", "x"])] == [
        "s0"]
    a.close()
    b.close()


def _open_ledger(path, barrier, errors):
    from specforge_tpu_torch.runtime.control_plane.metadata_store import (
        SQLiteMetadataStore,
    )
    barrier.wait()
    try:
        SQLiteMetadataStore(path).record_ack(["s0"], 1)
    except Exception as e:  # reported to the test
        errors.put(repr(e))


def test_sqlite_ledger_opened_by_ranks_at_once(tmp_path):
    """Processes that open one new ledger together (a multi-rank consumer
    does) all open it: the ones that lose the race for the switch to WAL
    retry it. Six processes, ten times over a fresh file."""
    ctx = multiprocessing.get_context("fork")
    for trial in range(10):
        path = str(tmp_path / f"ledger{trial}.sqlite")
        barrier, errors = ctx.Barrier(6), ctx.Queue()
        procs = [ctx.Process(target=_open_ledger,
                             args=(path, barrier, errors))
                 for _ in range(6)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(timeout=120)
        assert [proc.exitcode for proc in procs] == [0] * 6
        assert errors.empty(), errors.get()


def test_controller_lifecycle_and_poisoning(pkg):
    controller = pkg.controller.DataFlowController(max_attempts=2)
    controller.ingest_prompts([
        pkg.contracts.PromptTask(prompt_id=f"p{i}", payload={"text": "x"})
        for i in range(3)])
    leased = controller.lease_prompt_tasks("w0", limit=2)
    assert [t.prompt_id for t in leased] == ["p0", "p1"]
    controller.complete_prompt("p0")
    controller.fail_prompt("p1")  # attempt 1 of 2: leasable again
    leased2 = controller.lease_prompt_tasks("w1", limit=3)
    assert {t.prompt_id for t in leased2} == {"p1", "p2"}
    controller.fail_prompt("p1")  # attempt 2 of 2: poisoned
    assert controller.status()["prompts_poisoned"] == 1
    assert controller.lease_prompt_tasks("w2", limit=3) == []
    with pytest.raises(TypeError):  # the tensor firewall
        controller.ingest_prompts([pkg.contracts.PromptTask(
            prompt_id="t", payload={"ids": np.zeros(3)})])


def test_controller_ack_and_reconcile(pkg):
    released = []
    controller = pkg.controller.DataFlowController(
        pkg.metadata_store.InMemoryMetadataStore(),
        release_fn=released.extend)
    refs = [ref(pkg, i) for i in range(4)]
    assert len(controller.commit_samples(refs)) == 4
    assert controller.commit_samples(refs) == []  # dedup
    controller.ack_train_refs(["s0", "s1"], global_step=1)
    assert released == ["s0", "s1"]
    assert [r.sample_id for r in controller.reconcile_on_restart()] == [
        "s2", "s3"]
    assert controller.status()["samples_acked"] == 2
    noop = pkg.metadata_store.NoOpMetadataStore()
    assert noop.commit_sample(refs[0]) and noop.durable_step() == 0


def test_flow_control_hysteresis(pkg):
    fc = pkg.flow_control.ProducerFlowControl(
        pkg.flow_control.FlowControlConfig(high_watermark_refs=4,
                                           low_watermark_refs=2))
    fc.on_published(3)
    assert not fc.paused
    fc.on_published(1)
    assert fc.paused
    fc.on_consumed(1)
    assert fc.paused  # still above the low watermark
    fc.on_consumed(1)
    assert not fc.paused
    fc.set_in_flight(5)
    assert fc.paused
    assert fc.health()["pause_events"] == 2
    with pytest.raises(ValueError):
        pkg.flow_control.FlowControlConfig(high_watermark_refs=1,
                                           low_watermark_refs=2)


def test_channel_roundtrip_and_counters(pkg, tmp_path):
    producer = pkg.channel.StreamingRefChannel(str(tmp_path / "ctrl"))
    consumer = pkg.channel.StreamingRefChannel(str(tmp_path / "ctrl"))
    producer.publish_batch([ref(pkg, 0), ref(pkg, 1)])
    refs, closed, failure = consumer.poll()
    assert [r.sample_id for r in refs] == ["s0", "s1"]
    assert not closed and failure is None
    producer.publish_batch([ref(pkg, 2)])
    producer.close()
    refs2, closed2, _ = consumer.poll()
    assert [r.sample_id for r in refs2] == ["s2"] and closed2
    consumer.mark_consumed(3)
    assert producer.consumed_count() == 3
    assert producer.in_flight_remote() == 0
    consumer.publish_consumer_quantum(8)
    assert producer.consumer_quantum() == 8
    status = producer.status()
    assert (status.published, status.consumed, status.closed) == (3, 3, True)


def test_channel_failure_sentinel(pkg, tmp_path):
    producer = pkg.channel.StreamingRefChannel(str(tmp_path / "c2"))
    consumer = pkg.channel.StreamingRefChannel(str(tmp_path / "c2"))
    producer.publish_batch([ref(pkg, 0)])
    producer.fail("boom")
    refs, _closed, failure = consumer.poll()
    assert len(refs) == 1 and failure == "boom"


def test_distributor_windows_and_drop_last(pkg, tmp_path):
    channel_p = pkg.channel.StreamingRefChannel(str(tmp_path / "c3"))
    channel_c = pkg.channel.StreamingRefChannel(str(tmp_path / "c3"))
    dist = pkg.distributor.RefDistributor(
        channel_c, pkg.controller.DataFlowController(),
        str(tmp_path / "inbox"), world_size=2, window_samples=4)
    channel_p.publish_batch([ref(pkg, i) for i in range(3)])
    assert dist.pump() == 0  # below a whole window
    channel_p.publish_batch([ref(pkg, i) for i in range(3, 7)])
    assert dist.pump() == 4
    channel_p.close()
    dist.pump()
    assert dist.closed and dist.staged_count == 3
    dist.forward_consumed()
    assert channel_p.consumed_count() == 4
    inbox0 = pkg.distributor.InboxChannel(str(tmp_path / "inbox"), 0)
    inbox1 = pkg.distributor.InboxChannel(str(tmp_path / "inbox"), 1)
    r0, c0, _ = inbox0.poll()
    r1, c1, _ = inbox1.poll()
    assert [r.sample_id for r in r0] == ["s0", "s1"]
    assert [r.sample_id for r in r1] == ["s2", "s3"]
    assert c0 and c1  # closed in every inbox; s4..s6 dropped
    with pytest.raises(ValueError):
        pkg.distributor.RefDistributor(
            channel_c, pkg.controller.DataFlowController(),
            str(tmp_path / "inbox9"), world_size=3, window_samples=4)


def test_distributor_fans_out_a_failure(pkg, tmp_path):
    channel = pkg.channel.StreamingRefChannel(str(tmp_path / "c6"))
    dist = pkg.distributor.RefDistributor(
        pkg.channel.StreamingRefChannel(str(tmp_path / "c6")),
        pkg.controller.DataFlowController(), str(tmp_path / "inbox6"),
        world_size=2, window_samples=2)
    channel.fail("capture died")
    with pytest.raises(RuntimeError, match="capture died"):
        dist.pump()
    for rank in (0, 1):
        _, _, failure = pkg.distributor.InboxChannel(
            str(tmp_path / "inbox6"), rank).poll()
        assert failure == "capture died"


def test_distributor_resume_requeues_unacked(pkg, tmp_path):
    ledger = str(tmp_path / "ledger.sqlite")
    controller = pkg.controller.DataFlowController(
        pkg.metadata_store.SQLiteMetadataStore(ledger))
    controller.commit_samples([ref(pkg, i) for i in range(4)])
    controller.ack_train_refs(["s0", "s1"], 1)
    dist = pkg.distributor.RefDistributor(
        pkg.channel.StreamingRefChannel(str(tmp_path / "c4")),
        pkg.controller.DataFlowController(
            pkg.metadata_store.SQLiteMetadataStore(ledger)),
        str(tmp_path / "inbox2"), world_size=1, window_samples=2)
    assert dist.staged_count == 2  # s2, s3 requeued
    assert dist.pump() == 2
    refs, _, _ = pkg.distributor.InboxChannel(str(tmp_path / "inbox2"),
                                              0).poll()
    assert [r.sample_id for r in refs] == ["s2", "s3"]


def test_sample_ref_queue_lease_ack_fail(pkg):
    q = pkg.sample_ref_queue.SampleRefQueue(max_attempts=2)
    assert q.stage([ref(pkg, i) for i in range(3)]) == 3
    assert q.stage([ref(pkg, 0)]) == 0  # idempotent
    leased = q.lease("c0", limit=2)
    assert [r.sample_id for r in leased] == ["s0", "s1"]
    assert [r.sample_id for r in q.lease("c1", limit=5)] == ["s2"]
    q.ack(["s0"])
    q.fail(["s1"])  # attempt 1 of 2: ready again
    assert [r.sample_id for r in q.lease("c2", limit=5)] == ["s1"]
    q.fail(["s1"])  # attempt 2 of 2: poisoned
    assert q.status() == {"staged": 1, "leased": 1, "ready": 0, "acked": 1,
                          "poisoned": 1}


def test_rollout_worker_produces_and_verifies(pkg):
    controller = pkg.controller.DataFlowController(max_attempts=1)
    controller.ingest_prompts([
        pkg.contracts.PromptTask(prompt_id=f"p{i}", payload={})
        for i in range(3)])
    store = pkg.feature_store.InMemoryFeatureStore()
    published = []
    rng = np.random.default_rng(0)

    def source(task):
        width = 5 if task.prompt_id == "p1" else 6  # p1: a bad capture
        return [("0", {
            "input_ids": np.arange(4),
            "loss_mask": np.ones(4, np.int64),
            "hidden_state": rng.normal(size=(4, width)).astype(np.float32),
            "target": rng.normal(size=(4, 2)).astype(np.float32),
        }, {"target_repr": "hidden_state"})]

    worker = pkg.rollout_worker.RolloutWorker(
        "w0", controller=controller, store=store, feature_source=source,
        capture_config=pkg.capture.CaptureConfig(hidden_size=2,
                                                 num_capture_layers=3),
        publish_fn=published.extend)
    assert worker.drain() == 2
    assert worker.health.failed == 1
    assert controller.status()["prompts_poisoned"] == 1
    assert {r.prompt_id for r in published} == {"p0", "p2"}
    assert {r.sample_id for r in published} == {"p0/0", "p2/0"}
    with pytest.raises(ValueError, match="exactly one"):
        pkg.rollout_worker.RolloutWorker("w1", controller=controller)


def test_rollout_worker_drops_after_consecutive_failures(pkg):
    controller = pkg.controller.DataFlowController(max_attempts=5)
    controller.ingest_prompts([
        pkg.contracts.PromptTask(prompt_id=f"p{i}", payload={})
        for i in range(4)])

    def broken(task):
        raise RuntimeError("server down")

    worker = pkg.rollout_worker.RolloutWorker(
        "w0", controller=controller, ref_source=broken,
        max_consecutive_failures=2, lease_limit=4)
    assert worker.step() == 0
    assert worker.health.dropped and worker.health.failed == 2
    assert worker.drain() == 0


def test_dp_ack_collective(pkg, tmp_path):
    """Two ranks (threads) exchange acked ids; rank 0 records the union."""
    recorded = []
    c0 = pkg.dp_ack.DPAckController(
        str(tmp_path / "ack"), rank=0, world_size=2, timeout_s=10,
        ack_fn=lambda ids, step: recorded.append((step, sorted(ids))))
    c1 = pkg.dp_ack.DPAckController(str(tmp_path / "ack"), rank=1,
                                    world_size=2, timeout_s=10)
    results = {}

    def run(controller, rank, ids):
        results[rank] = controller.ack_train_refs(ids, step=1)

    threads = [threading.Thread(target=run, args=(c0, 0, ["a", "b"])),
               threading.Thread(target=run, args=(c1, 1, ["b", "c"]))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    assert sorted(results[0]) == sorted(results[1]) == ["a", "b", "c"]
    assert recorded == [(1, ["a", "b", "c"])]
    for step in (2, 3, 4):
        c0.world_size = 1
        c0.ack_train_refs(["z"], step=step)
    c0.cleanup(keep_last=2)
    assert not (tmp_path / "ack" / "step1.done").exists()
    assert (tmp_path / "ack" / "step4.done").exists()


def test_dp_ack_timeout(pkg, tmp_path):
    c0 = pkg.dp_ack.DPAckController(str(tmp_path / "ack2"), rank=0,
                                    world_size=2, timeout_s=0.3)
    with pytest.raises(TimeoutError):
        c0.ack_train_refs(["x"], step=5)
    c1 = pkg.dp_ack.DPAckController(str(tmp_path / "ack2"), rank=1,
                                    world_size=2, timeout_s=0.3)
    with pytest.raises(TimeoutError):
        c1.ack_train_refs(["y"], step=6)


# --------------------------------------------------------------------------
# state written by one package, read by the other
# --------------------------------------------------------------------------

DIRECTIONS = [("jax", "torch"), ("torch", "jax")]


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=[f"{w}-to-{r}" for w, r in DIRECTIONS])
def test_channel_file_crosses_packages(writer, reader, tmp_path):
    w, r = modules(writer), modules(reader)
    ctrl = str(tmp_path / "ctrl")
    producer = w.channel.StreamingRefChannel(ctrl)
    producer.publish_batch([ref(w, 0), ref(w, 1)])
    producer.close()
    consumer = r.channel.StreamingRefChannel(ctrl)
    refs, closed, failure = consumer.poll()
    assert [x.to_json() for x in refs] == [ref(r, 0).to_json(),
                                           ref(r, 1).to_json()]
    assert closed and failure is None
    consumer.mark_consumed(2)
    consumer.publish_consumer_quantum(4)
    assert producer.consumed_count() == 2 and producer.consumer_quantum() == 4
    # the bytes one package writes are the bytes the other would write
    other = tmp_path / "other"
    p2 = r.channel.StreamingRefChannel(str(other))
    p2.publish_batch([ref(r, 0), ref(r, 1)])
    p2.close()
    for name in ("refs.jsonl", "refs.published"):
        assert (tmp_path / "ctrl" / name).read_bytes() == (
            other / name).read_bytes()


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=[f"{w}-to-{r}" for w, r in DIRECTIONS])
def test_inbox_directory_crosses_packages(writer, reader, tmp_path):
    w, r = modules(writer), modules(reader)
    channel = w.channel.StreamingRefChannel(str(tmp_path / "ctrl"))
    dist = w.distributor.RefDistributor(
        w.channel.StreamingRefChannel(str(tmp_path / "ctrl")),
        w.controller.DataFlowController(), str(tmp_path / "inbox"),
        world_size=2, window_samples=2)
    channel.publish_batch([ref(w, i) for i in range(5)])
    channel.close()
    dist.pump()
    got = [r.distributor.InboxChannel(str(tmp_path / "inbox"), rank).poll()
           for rank in (0, 1)]
    assert [[x.sample_id for x in refs] for refs, _, _ in got] == [
        ["s0", "s2"], ["s1", "s3"]]
    assert all(closed for _, closed, _ in got)


@pytest.mark.parametrize("writer,reader", DIRECTIONS,
                         ids=[f"{w}-to-{r}" for w, r in DIRECTIONS])
def test_sqlite_ledger_crosses_packages(writer, reader, tmp_path):
    w, r = modules(writer), modules(reader)
    path = str(tmp_path / "ledger.sqlite")
    a = w.metadata_store.SQLiteMetadataStore(path)
    for i in range(3):
        a.commit_sample(ref(w, i))
    a.record_ack(["s0"], global_step=4)
    a.close()
    b = r.metadata_store.SQLiteMetadataStore(path)
    assert [x.to_json() for x in b.committed_refs()] == [
        ref(r, i).to_json() for i in range(3)]
    assert b.acked_ids() == {"s0"} and b.durable_step() == 4
    controller = r.controller.DataFlowController(b)
    assert [x.sample_id for x in controller.reconcile_on_restart()] == [
        "s1", "s2"]
    b.close()
