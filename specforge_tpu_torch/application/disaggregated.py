"""Disaggregated role runtimes: the producer and consumer workers.

Counterpart of ``specforge_tpu/application/disaggregated.py``: wires the
online topology from the config.

- **producer** (a CPU process; it creates no CUDA context): prompt plan →
  DataFlowController → capture-server adapters → RolloutWorkers →
  StreamingRefChannel, with hysteretic flow control fed by the channel's
  consumed counter, and a restart that skips what the channel already
  holds. It takes records that are already tokenised (``input_ids``, with
  an optional ``loss_mask``); the port imports no tokenizer package.
- **consumer** (the trainer, on CUDA unless a device is named): rank 0
  alone reads the channel (RefDistributor) into per-rank inboxes of the
  restart generation (``inboxes-g{durable step}``) → each rank's streaming
  loader → the Trainer, whose acks are buffered to checkpoint boundaries
  (ledger → store release → channel consumed counter → the producer
  resumes). Several ranks (``procs > 1``, the dp × fsdp mesh of
  ``parallel/multihost.py``) share the control directory or reach rank 0's
  inbox relay over HTTP (``runtime.inbox_server_url``).
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

from specforge_tpu_torch.config.schema import Config
from specforge_tpu_torch.data.prompt_builder import (
    load_prompt_records,
    prepare_prompt_tasks,
)
from specforge_tpu_torch.inference.batch_partition import TargetBatchPartition
from specforge_tpu_torch.inference.rollout_worker import RolloutWorker
from specforge_tpu_torch.inference.server_capture_adapter import (
    HTTPCaptureAdapter,
)
from specforge_tpu_torch.runtime.control_plane.controller import (
    DataFlowController,
)
from specforge_tpu_torch.runtime.control_plane.flow_control import (
    FlowControlConfig,
    ProducerFlowControl,
)
from specforge_tpu_torch.runtime.control_plane.metadata_store import (
    SQLiteMetadataStore,
)
from specforge_tpu_torch.runtime.data_plane.streaming_ref_channel import (
    StreamingRefChannel,
)
from specforge_tpu_torch.utils import DeviceLike

logger = logging.getLogger("specforge_tpu_torch.disaggregated")


def _control_dir(config: Config) -> str:
    return config.runtime.control_dir or os.path.join(
        config.output_dir, config.run_id, "control")


def _build_store(config: Config):
    backend = config.runtime.store_backend
    if backend == "network":
        from specforge_tpu_torch.runtime.data_plane.network_store import (
            NetworkFeatureStore,
        )

        return NetworkFeatureStore(config.runtime.store_endpoint,
                                   secret=config.runtime.store_secret)
    if backend == "shared_dir":
        from specforge_tpu_torch.runtime.data_plane.feature_store import (
            SharedDirFeatureStore,
        )

        return SharedDirFeatureStore(config.runtime.store_dir)
    from specforge_tpu_torch.runtime.data_plane.feature_store import (
        InMemoryFeatureStore,
    )

    return InMemoryFeatureStore()


def run_producer(config: Config, *, poll_interval: float = 0.2) -> int:
    """Drive capture until the prompt plan drains; returns the samples
    produced by this run."""
    if config.training.resume_from is not None:
        # the schema rejects role="producer"; a role="auto" process that
        # resolves to a producer must not ignore the setting either
        raise ValueError(
            "training.resume_from is valid only for a trainer role")
    if not config.data.prompt_path:
        raise ValueError("online producer requires data.prompt_path")
    records = load_prompt_records(config.data.prompt_path)
    if any("input_ids" not in r for r in records):
        raise ValueError(
            "the port's online producer takes tokenised prompt records "
            "(input_ids, and loss_mask where only part is supervised); it "
            "imports no tokenizer package. Tokenise conversations first, "
            "e.g. with specforge_tpu_torch.data.parse.build_dataset(records, "
            "tokenizer, template, max_length)")
    tasks = prepare_prompt_tasks(records, epoch=0,
                                 prompt_seed=config.training.seed)
    controller = DataFlowController()
    controller.ingest_prompts(tasks)

    channel = StreamingRefChannel(_control_dir(config))
    # a restart: the channel file is the durable record of what was
    # published, so those prompts are skipped (exactly-once publication; a
    # crash between the store put and the publish captures again, which at
    # worst overwrites the same store keys)
    replayed, _closed, _failure = StreamingRefChannel(
        _control_dir(config)).poll()
    for ref in replayed:
        controller.complete_prompt(ref.prompt_id
                                   or ref.sample_id.split("/", 1)[0])
    if replayed:
        logger.info("producer restart: skipping %d already-published "
                    "prompts", len(replayed))
    flow = ProducerFlowControl(FlowControlConfig(
        high_watermark_refs=config.runtime.flow_high_watermark,
        low_watermark_refs=config.runtime.flow_low_watermark,
    ))
    store = _build_store(config)
    use_store_sink = config.runtime.store_backend == "network"

    batch_size = config.runtime.capture_batch_size
    workers: List[RolloutWorker] = []
    for i, url in enumerate(config.deployment.server_urls):
        adapter = HTTPCaptureAdapter(
            url, store=store,
            store_endpoint=(config.runtime.store_endpoint
                            if use_store_sink else None),
        )
        source_kwargs = (
            dict(batch_ref_source=adapter.produce_refs_batch,
                 batch_partition=TargetBatchPartition(
                     max_batch_tokens=config.runtime.capture_batch_tokens,
                     max_batch_size=batch_size),
                 lease_limit=batch_size)
            if batch_size > 1 else dict(ref_source=adapter.produce_refs)
        )
        workers.append(RolloutWorker(
            f"producer-{i}", controller=controller,
            publish_fn=lambda refs, _c=channel: _c.publish_batch(refs),
            flow_control=flow, **source_kwargs,
        ))
    if not workers:
        raise ValueError("online producer requires deployment.server_urls")

    produced = 0
    try:
        while True:
            flow.set_in_flight(channel.in_flight_remote())
            round_produced = sum(w.step() for w in workers)
            produced += round_produced
            status = controller.status()
            if status["prompts_pending"] == 0:
                break
            if all(w.health.dropped for w in workers):
                raise RuntimeError("all producer workers dropped")
            if round_produced == 0:
                time.sleep(poll_interval)
        channel.close()
        logger.info("producer done: %d samples, status=%s", produced, status)
        return produced
    except Exception as exc:
        channel.fail(str(exc))
        raise


class InboxFeeder:
    """A background thread polling a rank's inbox into the loader's
    queue; ``None`` in the queue ends the stream."""

    def __init__(self, inbox, poll_interval: float = 0.1):
        self.inbox = inbox
        self.queue: "queue.Queue" = queue.Queue()
        self.poll_interval = poll_interval
        self.failure: Optional[str] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            refs, closed, failure = self.inbox.poll()
            for ref in refs:
                self.queue.put(ref)
            if failure:
                self.failure = failure
                self.queue.put(None)
                return
            if closed:
                self.queue.put(None)
                return
            if not refs:
                time.sleep(self.poll_interval)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


class _RecordingQueue:
    """The loader's view of the feeder queue: records each ref it hands
    out, so an ack can release it."""

    def __init__(self, inner, seen: Dict[str, Any]):
        self.inner = inner
        self.seen = seen

    def get(self, timeout=None):
        item = self.inner.get(timeout=timeout)
        if item is not None:
            self.seen[item.sample_id] = item
        return item


def run_consumer(config: Config, frozen_override=None,
                 device: DeviceLike = None) -> Dict[str, float]:
    """Online consumer: distributor, streaming loader and Trainer. Returns
    the trainer's last metrics and, after the last ack, the store's numeric
    counters (``store/<name>``; a network store also reports the bytes
    this consumer fetched, ``store/fetched_bytes``)."""
    from specforge_tpu_torch.application.composition import (
        build_training_run,
    )
    from specforge_tpu_torch.parallel.multihost import (
        barrier,
        is_primary,
        maybe_initialize_distributed,
        process_count,
        process_index,
    )
    from specforge_tpu_torch.runtime.data_plane.feature_dataloader import (
        FeatureDataLoader,
    )
    from specforge_tpu_torch.runtime.data_plane.ref_distributor import (
        InboxChannel,
        RefDistributor,
    )
    from specforge_tpu_torch.utils import resolve_device

    device = maybe_initialize_distributed(resolve_device(device))
    procs = process_count()
    rank = process_index()
    primary = is_primary()

    t = config.training
    if t.total_steps is None:
        raise ValueError("online consumer requires training.total_steps")
    if t.resume and t.save_interval <= 0:
        # without checkpoints, per-step durable acks would release samples
        # a restart can never recover (acks must not run ahead of the
        # restorable state)
        raise ValueError(
            "online consumer with training.resume=true requires "
            "training.save_interval > 0 (acks flush at checkpoint "
            "boundaries; without checkpoints a restart would lose every "
            "acked sample)")
    if t.attention_backend == "usp":
        raise NotImplementedError(
            "a sequence-parallel online consumer: the inboxes split each "
            "window over the dp x fsdp ranks only")
    if t.batch_size % procs != 0:
        raise ValueError(
            f"training.batch_size={t.batch_size} (global) must divide by "
            f"{procs} consumer processes")
    window = t.batch_size * t.accumulation_steps
    store = _build_store(config)
    state_dir = os.path.join(config.output_dir, config.run_id,
                             "consumer_state")

    # ranks without the shared control directory: the channel, ledger and
    # distributor live on the primary; this rank polls its inbox and routes
    # acks over the primary's HTTP relay
    relay_url = config.runtime.inbox_server_url
    remote_mode = (not primary) and bool(relay_url)

    ledger = None
    controller = None
    relay_server = None
    stop_pump = threading.Event()
    pump_failure: List[BaseException] = []
    inbox_dir = None
    if not remote_mode:
        channel = StreamingRefChannel(_control_dir(config))
        ledger = SQLiteMetadataStore(os.path.join(state_dir,
                                                  "consumer.sqlite"))
        controller = DataFlowController(ledger)
        if primary:
            channel.publish_consumer_quantum(window)
        # the restart generation: a restarted consumer must not replay the
        # inbox entries distributed before the crash, so each (re)start
        # reads a fresh inbox keyed by the ledger's durable step, which the
        # primary clears before staging (a crash before the first ack
        # leaves the durable step as it was); the distributor requeues
        # exactly the committed but unacked tail
        durable = ledger.durable_step() or 0
        inbox_dir = os.path.join(state_dir, f"inboxes-g{durable}")
        if primary:
            if os.path.exists(inbox_dir):
                shutil.rmtree(inbox_dir)
            distributor = RefDistributor(channel, controller, inbox_dir,
                                         world_size=procs,
                                         window_samples=window)

            def pump():
                try:
                    while not stop_pump.is_set():
                        distributor.pump()
                        distributor.forward_consumed()
                        if distributor.closed:
                            return
                        time.sleep(0.1)
                except BaseException as exc:  # noqa: BLE001 — re-raised
                    pump_failure.append(exc)

            threading.Thread(target=pump, daemon=True).start()

    if procs > 1:
        # every rank waits: shared-dir ranks must not open the generation's
        # directory before the primary cleared it
        barrier("inbox-generation")
    if remote_mode:
        from specforge_tpu_torch.runtime.data_plane.http_inbox import (
            RemoteInboxChannel,
        )

        inbox = RemoteInboxChannel(relay_url, rank)
    else:
        inbox = InboxChannel(inbox_dir, rank)
    feeder = InboxFeeder(inbox).start()
    ref_by_id: Dict[str, Any] = {}
    release_fn = getattr(store, "release_refs", None)

    def apply_ack(ids: List[str], step: int):
        """The authority's durable ack: ledger marker, then store
        release."""
        controller.ack_train_refs(ids, step)
        refs = [ref_by_id.pop(sid) for sid in ids if sid in ref_by_id]
        have = {r.sample_id for r in refs}
        missing = [sid for sid in ids if sid not in have]
        if missing:
            # other ranks' refs never went through this rank's loader
            refs.extend(ledger.committed_refs_by_ids(missing))
        if release_fn is not None:
            release_fn(refs)
        else:
            store.release(ids)

    if primary and config.runtime.inbox_server_port:
        from specforge_tpu_torch.runtime.data_plane.http_inbox import (
            InboxHTTPServer,
        )

        relay_server = InboxHTTPServer(
            inbox_dir, port=config.runtime.inbox_server_port,
            ack_fn=apply_ack).start()
        logger.info("inbox relay serving on port %d", relay_server.port)

    # acks never run ahead of checkpoints: they are buffered and flushed at
    # checkpoint boundaries (and at the end), so a restart resumes from the
    # checkpoint with every unacked sample delivered again
    ack_every = t.save_interval if t.save_interval > 0 else 1
    ack_buffer: List[str] = []

    def flush_acks(step: int):
        if not ack_buffer:
            return
        ids, ack_buffer[:] = list(ack_buffer), []
        if remote_mode:
            inbox.post_ack(ids, step)
            inbox.report_consumed()
            for sid in ids:
                ref_by_id.pop(sid, None)
        else:
            apply_ack(ids, step)

    def ack_fn(sample_ids: List[str], step: int):
        ack_buffer.extend(sample_ids)
        if step % ack_every == 0:
            flush_acks(step)

    def train_loader_fn(collate, rows, metadata):
        return FeatureDataLoader(
            store, collate,
            ref_queue=_RecordingQueue(feeder.queue, ref_by_id),
            batch_size=rows, num_workers=config.data.num_workers,
            prefetch_batches=config.data.prefetch_batches,
            metadata=metadata)

    try:
        trainer = build_training_run(
            config, frozen_override=frozen_override, device=device,
            train_loader_fn=train_loader_fn, ack_fn=ack_fn)
        try:
            metrics = trainer.fit()
        finally:
            trainer.tracker.finish()
        flush_acks(int(trainer.state.step))
        if feeder.failure:
            raise RuntimeError(f"producer failed: {feeder.failure}")
        if pump_failure:
            raise RuntimeError("the ref distributor failed") \
                from pump_failure[0]
        health = store.health()
        metrics.update({f"store/{k}": float(v) for k, v in health.items()
                        if isinstance(v, (int, float))
                        and not isinstance(v, bool)})
        if hasattr(store, "fetched_bytes"):
            metrics["store/fetched_bytes"] = float(store.fetched_bytes)
        return metrics
    finally:
        stop_pump.set()
        feeder.stop()
        if relay_server is not None:
            relay_server.stop()
        if ledger is not None:
            ledger.close()
