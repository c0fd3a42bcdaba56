"""HTTP inbox relay: multi-host consumers without a shared control
filesystem.

Counterpart of ``specforge_tpu/runtime/data_plane/http_inbox.py``: rank 0
(the RefDistributor's host) serves its per-rank inbox JSONL files over HTTP
with byte-offset idempotent reads; remote ranks poll through
:class:`RemoteInboxChannel` (the interface of ``InboxChannel``) and report
their consumed counts and acks back.

Endpoints:
    GET  /inbox/<rank>?offset=N   → {"lines": [...], "next_offset": M}
    POST /consumed                → {"rank": r, "count": n} (monotonic max)
    POST /ack                     → {"rank": r, "sample_ids": [...],
                                     "step": n}
    GET  /health                  → {"status": "ok", "ranks": K}
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from specforge_tpu_torch.runtime.contracts import SampleRef


class InboxHTTPServer:
    def __init__(self, inbox_dir: str, host: str = "0.0.0.0", port: int = 0,
                 ack_fn=None):
        """``ack_fn(sample_ids, step)``: applied on POST /ack — remote ranks
        route durable acks through the authority host (SQLite ledger + store
        release stay on rank 0; no shared filesystem required)."""
        self.inbox_dir = os.path.abspath(inbox_dir)
        self._consumed: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.ack_fn = ack_fn
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code, obj):
                payload = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                if parsed.path == "/health":
                    with server._lock:
                        ranks = len(server._consumed)
                    self._reply(200, {"status": "ok", "ranks": ranks})
                    return
                if parsed.path.startswith("/inbox/"):
                    try:
                        rank = int(parsed.path.split("/")[2])
                    except (IndexError, ValueError):
                        self._reply(400, {"error": "bad rank"})
                        return
                    query = urllib.parse.parse_qs(parsed.query)
                    offset = int(query.get("offset", ["0"])[0])
                    lines, next_offset = server.read_inbox(rank, offset)
                    self._reply(
                        200, {"lines": lines, "next_offset": next_offset}
                    )
                    return
                self._reply(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length))
                if self.path == "/consumed":
                    server.record_consumed(
                        int(body["rank"]), int(body["count"])
                    )
                    self._reply(200, {"status": "ok"})
                    return
                if self.path == "/ack":
                    if server.ack_fn is None:
                        self._reply(400, {"error": "acks not accepted"})
                        return
                    try:
                        server.ack_fn(
                            list(body["sample_ids"]), int(body["step"])
                        )
                        self._reply(200, {"status": "ok"})
                    except Exception as exc:  # noqa: BLE001 — report upstream
                        self._reply(500, {"error": str(exc)})
                    return
                self._reply(404, {"error": "not found"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def read_inbox(self, rank: int, offset: int) -> Tuple[List[str], int]:
        """Complete lines from byte ``offset``; partial tails are excluded so
        reads are idempotent under concurrent appends."""
        path = os.path.join(self.inbox_dir, f"rank{rank}.jsonl")
        if not os.path.exists(path):
            return [], offset
        lines: List[str] = []
        with open(path, "r") as f:
            f.seek(offset)
            while True:
                start = f.tell()
                line = f.readline()
                if not line or not line.endswith("\n"):
                    return lines, start
                lines.append(line.rstrip("\n"))

    def record_consumed(self, rank: int, count: int) -> None:
        with self._lock:
            self._consumed[rank] = max(self._consumed.get(rank, 0), count)

    def total_consumed(self) -> int:
        with self._lock:
            return sum(self._consumed.values())

    def start(self):
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        if self._thread:
            self._thread.join(timeout=5)


class RemoteInboxChannel:
    """Drop-in for InboxChannel on hosts without the shared control dir."""

    def __init__(self, base_url: str, rank: int, timeout: float = 30.0,
                 startup_grace_s: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.rank = rank
        self.timeout = timeout
        self.startup_grace_s = startup_grace_s
        self._offset = 0
        self.consumed = 0
        self._first_failure: Optional[float] = None

    def poll(self):
        import time as _time

        url = (
            f"{self.base_url}/inbox/{self.rank}?offset={self._offset}"
        )
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as resp:
                body = json.loads(resp.read())
        except OSError:
            # the authority's relay may start after this rank: tolerate
            # connection errors within the startup grace window
            now = _time.monotonic()
            if self._first_failure is None:
                self._first_failure = now
            if now - self._first_failure > self.startup_grace_s:
                raise
            return [], False, None
        self._first_failure = None
        return self._parse(body)

    def _parse(self, body):
        self._offset = body["next_offset"]
        refs: List[SampleRef] = []
        closed = False
        failure: Optional[str] = None
        for line in body["lines"]:
            record = json.loads(line)
            kind = record.pop("kind", "ref")
            if kind == "ref":
                refs.append(SampleRef.from_json(record))
            elif kind == "closed":
                closed = True
            elif kind == "failed":
                failure = record.get("error", "producer failed")
        self.consumed += len(refs)
        return refs, closed, failure

    def report_consumed(self) -> None:
        data = json.dumps({"rank": self.rank, "count": self.consumed}).encode()
        req = urllib.request.Request(
            f"{self.base_url}/consumed", data=data,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout):
            pass

    def post_ack(self, sample_ids, step: int) -> None:
        """Route a durable ack through the authority host's ledger/store."""
        data = json.dumps({
            "rank": self.rank, "sample_ids": list(sample_ids),
            "step": int(step),
        }).encode()
        req = urllib.request.Request(
            f"{self.base_url}/ack", data=data,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            if resp.status != 200:
                raise RuntimeError(f"remote ack failed: {resp.status}")
