"""Online capture server: the frozen target behind HTTP, capturing
training features during its prefill.

Counterpart of ``specforge_tpu/inference/capture_server.py``, with its
endpoints, request and response formats. With a ``spec_capture`` sink
pointing at the network feature store the server writes the tensors
**into the store itself** and the response's ``meta_info.spec_capture``
carries only keys, shapes and dtypes; otherwise the tensors come back
inline (base64 of their raw bytes) for small runs and tests.

On a capture mesh (``capture_server_main --shard-over-devices N``) every
rank holds its shards of the target: rank 0 serves HTTP and, for each
padded batch, broadcasts it (or a stop, or a heartbeat while idle, well
inside the collectives' timeout) to the other ranks, which follow in
:meth:`CaptureEngine.follow`; every rank runs the forward and rank 0
answers.

Endpoints:
    GET  /health          → {"status": "ok", "layout", "coalesce",
                             "device", "ranks", "max_memory_allocated"}
                             once every rank has loaded the target
    POST /generate        → body {"input_ids": [...], "loss_mask": [...],
                                  "sample_id": str,
                                  "spec_capture": {"sink": "store"|"inline",
                                                   "store": "host:port",
                                                   "generation": int}}
    POST /generate_batch  → body {"samples": [{input_ids, loss_mask,
                                               sample_id}, ...],
                                  "spec_capture": {...}}
                            → {"results": [per-sample meta_info dicts]}
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from specforge_tpu_torch.utils import DeviceLike

logger = logging.getLogger("specforge_tpu_torch.capture_server")


class RequestCoalescer:
    """Server-side micro-batching of concurrent single ``/generate``
    requests: requests collected for a short window (or up to
    ``max_batch``) run as ONE bucketed forward. A worker thread drains the
    queue; each item carries an event its handler thread waits on. The
    first dequeue blocks, so an idle server pays nothing."""

    def __init__(self, engine, window_ms: float = 4.0, max_batch: int = 16):
        self._engine = engine
        self._window = window_ms / 1000.0
        self._max = max_batch
        self._q: "queue.Queue" = queue.Queue()
        self.batches_run = 0       # forwards actually executed
        self.requests_served = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def capture(self, input_ids: np.ndarray, loss_mask: np.ndarray):
        item = {"sample": (input_ids, loss_mask),
                "event": threading.Event(), "result": None, "error": None}
        self._q.put(item)
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def stop(self):
        self._q.put(None)
        self._thread.join(timeout=5)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self._window
            while len(batch) < self._max:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._flush(batch)
                    return
                batch.append(nxt)
            self._flush(batch)

    def _flush(self, batch):
        try:
            results = self._engine.capture_batch(
                [it["sample"] for it in batch])
            for it, res in zip(batch, results):
                it["result"] = res
        except Exception as exc:  # noqa: BLE001 — to each waiter
            for it in batch:
                it["error"] = exc
        self.batches_run += 1
        self.requests_served += len(batch)
        for it in batch:
            it["event"].set()


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def resolve_batch_shape(
    n_samples: int, longest: int, max_length: int,
    seq_buckets: Sequence[int], batch_buckets: Sequence[int],
) -> tuple:
    """(bsz, seq): the padded bucket shape covering the request on BOTH
    axes; the terminal bucket always covers the data."""
    buckets = [b for b in seq_buckets if b < max_length]
    buckets.append(max_length)
    seq = _bucket(min(longest, max_length), buckets)
    cap = [b for b in batch_buckets if b < n_samples]
    terminal = 1
    while terminal < n_samples:
        terminal *= 2
    cap.append(terminal)
    return _bucket(n_samples, cap), seq


def dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


#: what rank 0 broadcasts ahead of each forward
_STOP, _BATCH, _BEAT = 0, 1, 2


class CaptureEngine:
    """The target's capture forward behind a lock.

    :meth:`capture_batch` pads a request batch to bucketed (batch, seq)
    shapes, as the JAX engine does, and runs ONE forward of the port's
    ``OfflineCaptureRunner`` on its device (CUDA unless ``device`` names
    another; on a capture ``mesh`` this rank's device, with the other
    ranks following); the lock serialises the device, and the collectives,
    across server threads. The captured features are cast to bf16. A
    failure on a mesh other than a capacity overflow leaves the ranks out
    of step: it is kept in ``fatal`` and ``on_fatal`` is called."""

    SEQ_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)
    BATCH_BUCKETS = (1, 2, 4, 8, 16)
    #: seconds between rank 0's heartbeats to idle ranks
    HEARTBEAT_S = 60.0

    def __init__(self, target_model_path: str, capture_layers: Sequence[int],
                 layout: str = "eagle", max_length: int = 2048,
                 target_config=None, target_params=None, mesh=None,
                 moe_impl: Optional[str] = None,
                 moe_capacity_factor: Optional[float] = None,
                 device: DeviceLike = None):
        from specforge_tpu_torch.offline_capture.capture import (
            OfflineCaptureConfig,
            OfflineCaptureRunner,
        )

        self.layout = layout
        self.max_length = max_length
        self._runner = OfflineCaptureRunner(
            OfflineCaptureConfig(
                target_model_path=target_model_path,
                output_dir="unused",
                capture_layers=tuple(capture_layers),
                max_length=max_length,
                batch_size=1,
                layout=layout,
            ),
            target_config=target_config,
            target_params=target_params,
            mesh=mesh,
            moe_impl=moe_impl or "gathered",
            moe_capacity_factor=moe_capacity_factor,
            device=device,
        )
        self.device = self._runner.device
        self.mesh = mesh
        self.primary = self._runner.primary
        self.aux_name, self.last_name = {
            "eagle": ("hidden_state", "target"),
            "dflash": ("hidden_states", "target_last_hidden_states"),
        }[layout]
        self._device_lock = threading.Lock()
        self._followed = mesh is not None and mesh.world_size > 1
        self._stopped = threading.Event()
        self.fatal: Optional[BaseException] = None
        self.on_fatal = None
        if self._followed and self.primary:
            threading.Thread(target=self._heartbeat, daemon=True).start()

    # -- rank 0 and the ranks that follow it -------------------------------
    def _broadcast(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        from specforge_tpu_torch.parallel.usp import Staged

        call = Staged(self.mesh, [x])
        src = call.stage(x)
        dist.broadcast(src, 0)
        return call.done(src)

    def _announce(self, op: int, ids=None, mask=None) -> None:
        """Rank 0: the next step of the ranks that follow."""
        shape = (0, 0) if ids is None else ids.shape
        self._broadcast(torch.tensor([op, *shape], dtype=torch.int64,
                                     device=self.device))
        if ids is not None:
            for x in (ids, mask):
                self._broadcast(torch.as_tensor(x, device=self.device))

    def _heartbeat(self) -> None:
        while not self._stopped.wait(self.HEARTBEAT_S):
            with self._device_lock:
                if not self._stopped.is_set():
                    self._announce(_BEAT)

    def follow(self) -> int:
        """A rank other than 0: run every batch rank 0 broadcasts, until
        its stop → the batches run."""
        from specforge_tpu_torch.offline_capture.capture import (
            CapacityOverflow,
        )

        runs = 0
        while True:
            op, bsz, seq = self._broadcast(torch.zeros(
                3, dtype=torch.int64, device=self.device)).tolist()
            if op == _STOP:
                return runs
            if op == _BEAT:
                continue
            ids, mask = (self._broadcast(torch.empty(
                (bsz, seq), dtype=torch.int64, device=self.device))
                for _ in range(2))
            try:
                self._runner._run_batch(ids, mask)
            except CapacityOverflow:
                pass  # rank 0 raised it too, after the same forward
            runs += 1

    def stop_followers(self) -> None:
        """Rank 0: end the other ranks' :meth:`follow`."""
        self._stopped.set()
        if self._followed and self.fatal is None:
            with self._device_lock:
                self._announce(_STOP)

    def _run(self, ids: np.ndarray, mask: np.ndarray):
        from specforge_tpu_torch.offline_capture.capture import (
            CapacityOverflow,
        )

        if not self._followed:
            return self._runner._run_batch(ids, mask)
        if self.fatal is not None:
            raise RuntimeError(f"the capture mesh failed: {self.fatal!r}")
        try:
            self._announce(_BATCH, ids, mask)
            return self._runner._run_batch(ids, mask)
        except CapacityOverflow:
            raise
        except BaseException as exc:
            self.fatal = exc
            if self.on_fatal is not None:
                self.on_fatal()
            raise

    def capture(self, input_ids: np.ndarray, loss_mask: np.ndarray):
        return self.capture_batch([(input_ids, loss_mask)])[0]

    def pad_batch(self, samples):
        """(ids, attention mask, lengths): the padded bucket arrays one
        forward takes for ``samples`` [(input_ids, loss_mask)]."""
        lengths = [min(len(ids), self.max_length) for ids, _ in samples]
        bsz, seq = resolve_batch_shape(
            len(samples), max(lengths), self.max_length,
            self.SEQ_BUCKETS, self.BATCH_BUCKETS)
        ids = np.zeros((bsz, seq), np.int64)
        mask = np.zeros((bsz, seq), np.int64)
        for i, ((sample_ids, _), length) in enumerate(zip(samples, lengths)):
            ids[i, :length] = np.asarray(sample_ids)[:length]
            mask[i, :length] = 1
        return ids, mask, lengths

    def capture_batch(self, samples):
        """``samples``: [(input_ids, loss_mask)] → a dict of CPU tensors
        per sample, from one forward at bucketed shapes."""
        ids, mask, lengths = self.pad_batch(samples)
        with self._device_lock:
            aux, last = self._run(ids, mask)
        out = []
        for i, ((sample_ids, sample_mask), length) in enumerate(
                zip(samples, lengths)):
            out.append({
                "input_ids": torch.as_tensor(
                    np.asarray(sample_ids[:length], np.int64)),
                "loss_mask": torch.as_tensor(
                    np.asarray(sample_mask[:length], np.int64)),
                self.aux_name: aux[i, :length].to(torch.bfloat16),
                self.last_name: last[i, :length].to(torch.bfloat16),
            })
        return out


def _tensor_meta(tensors: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return {name: {"shape": list(t.shape), "dtype": dtype_name(t)}
            for name, t in tensors.items()}


def _raw_bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


class CaptureServer:
    def __init__(self, engine: CaptureEngine, host: str = "127.0.0.1",
                 port: int = 0, coalesce_window_ms: float = 4.0,
                 coalesce_max_batch: int = 16):
        self.engine = engine
        self.coalescer = RequestCoalescer(
            engine, window_ms=coalesce_window_ms,
            max_batch=coalesce_max_batch)
        self._stores: Dict[str, Any] = {}
        self._lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                if self.path == "/health":
                    self._reply(200, server.health())
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                handlers = {
                    "/generate": server.handle_generate,
                    "/generate_batch": server.handle_generate_batch,
                }
                handler = handlers.get(self.path)
                if handler is None:
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(self.rfile.read(length))
                    self._reply(200, handler(body))
                except Exception as exc:  # noqa: BLE001 — to the client
                    logger.exception("generate failed")
                    self._reply(500, {"error": str(exc)})

            def _reply(self, code, obj):
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def health(self) -> Dict[str, Any]:
        device = self.engine.device
        out = {
            "status": "ok",
            "layout": self.engine.layout,
            "coalesce": {"batches": self.coalescer.batches_run,
                         "requests": self.coalescer.requests_served},
            "device": str(device),
            "ranks": 1 if self.engine.mesh is None
            else self.engine.mesh.world_size,
        }
        if device.type == "cuda":
            out["device_name"] = torch.cuda.get_device_name(device)
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated(
                device)
        return out

    def _store_for(self, endpoint: str, generation: int):
        from specforge_tpu_torch.runtime.data_plane.network_store import (
            NetworkFeatureStore,
        )

        key = f"{endpoint}#g{generation}"
        with self._lock:
            if key not in self._stores:
                self._stores[key] = NetworkFeatureStore(
                    endpoint, generation=generation)
            return self._stores[key]

    @staticmethod
    def _sample(req: Dict[str, Any]) -> tuple:
        ids = np.asarray(req["input_ids"], np.int64)
        raw_mask = req.get("loss_mask")  # the key may be present but null
        mask = np.asarray(raw_mask if raw_mask is not None
                          else np.ones_like(ids), np.int64)
        return ids, mask

    def handle_generate_batch(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """One forward covers the whole batch of ``body["samples"]``."""
        spec = body.get("spec_capture") or {}
        requests = body["samples"]
        batch_tensors = self.engine.capture_batch(
            [self._sample(req) for req in requests])
        results = [
            self._sink_one(str(req.get("sample_id", f"sample-{i}")),
                           tensors, spec)
            for i, (req, tensors) in enumerate(zip(requests, batch_tensors))
        ]
        return {"results": results}

    def handle_generate(self, body: Dict[str, Any]) -> Dict[str, Any]:
        input_ids, loss_mask = self._sample(body)
        sample_id = str(body.get("sample_id", "sample"))
        spec = body.get("spec_capture") or {}
        # concurrent single requests coalesce into one bucketed forward
        tensors = self.coalescer.capture(input_ids, loss_mask)
        return self._sink_one(sample_id, tensors, spec)

    def _sink_one(self, sample_id: str, tensors: Dict[str, torch.Tensor],
                  spec: Dict[str, Any]) -> Dict[str, Any]:
        meta = _tensor_meta(tensors)
        sink = spec.get("sink", "inline")
        if sink == "store":
            store = self._store_for(spec["store"],
                                    int(spec.get("generation", 0)))
            ref = store.put_sample(sample_id, tensors)
            return {"meta_info": {"spec_capture": {
                "sample_id": sample_id,
                "sink": "store",
                "store": spec["store"],
                "generation": int(spec.get("generation", 0)),
                "features": meta,
                "uris": {name: handle.uri
                         for name, handle in ref.features.items()},
            }}}
        if sink == "inline":
            blobs = {name: base64.b64encode(_raw_bytes(t)).decode()
                     for name, t in tensors.items()}
            return {"meta_info": {"spec_capture": {
                "sample_id": sample_id,
                "sink": "inline",
                "features": meta,
                "data": blobs,
            }}}
        raise ValueError(f"unknown spec_capture sink {sink!r}")

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)
        self.coalescer.stop()
        self.httpd.server_close()
