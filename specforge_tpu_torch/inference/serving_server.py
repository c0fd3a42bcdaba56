"""HTTP serving endpoint over the chain and block speculative decoders.

Counterpart of ``specforge_tpu/inference/serving_server.py``: the port
serves a trained, exported draft natively behind the same minimal
threaded-HTTP surface, with ``Eagle3SpecDecoder`` or ``DFlashSpecDecoder``
(``inference/spec_decode.py``).

Endpoints:
  GET  /health    status, decoder family and config (``num_draft_tokens``
                  for the chain decoder, ``block_size`` for the block
                  decoder), counters
  POST /generate  {"input_ids": [...], "max_new_tokens": N,
                   "stop_token_ids"?, "plain"?: true}
                  → {"output_ids", "new_tokens", "accept_lengths",
                     "mean_accept_length", "rounds", "wall_ms"}
                  (``plain``: fused plain greedy decoding, the baseline;
                  no accept lengths)

Tree requests (``topk`` > 1) answer 400, naming ``ROADMAP.md`` Queue 1
item 8c for the chain decoder (the block decoder proposes one block a
round), and ``/generate_batch`` answers 400 naming item 8d, as a malformed
body does. Requests serialize on a device lock: one card, one decode at a
time.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from specforge_tpu_torch.inference.spec_decode import (
    BATCH_LATER,
    TREE_LATER,
    fused_plain_decode,
)

logger = logging.getLogger(__name__)


class SpecServingServer:
    """Thin HTTP front over one spec decoder (see the module docstring)."""

    def __init__(self, decoder, host: str = "127.0.0.1", port: int = 0,
                 default_max_new_tokens: int = 128):
        self.decoder = decoder
        self.default_max_new_tokens = default_max_new_tokens
        self._device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.requests_served = 0
        self.tokens_emitted = 0
        self.decode_seconds = 0.0
        server = self

        info: Dict[str, Any] = {"family": type(decoder).__name__,
                                "max_len": decoder.max_len}
        if hasattr(decoder, "k"):
            info["num_draft_tokens"] = decoder.k
        if hasattr(decoder, "block_size"):
            info["block_size"] = decoder.block_size

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                if self.path == "/health":
                    with server._stats_lock:
                        secs = server.decode_seconds
                        counters = {
                            "requests": server.requests_served,
                            "output_tokens": server.tokens_emitted,
                            "decode_seconds": round(secs, 4),
                            "output_throughput": round(
                                server.tokens_emitted / secs, 2
                            ) if secs > 0 else 0.0,
                        }
                    self._reply(200, {"status": "ok", **info,
                                      "counters": counters})
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
                except (ValueError, KeyError, TypeError):
                    self._reply(400, {"error": "malformed JSON body"})
                    return
                try:
                    self._reply(200, handler(body))
                except (KeyError, ValueError, TypeError) as exc:
                    # client-input faults (a missing field, a mode this
                    # decoder does not serve, bad types) are 4xx, and the
                    # message carries no traceback
                    logger.warning("bad request on %s: %s", self.path, exc)
                    self._reply(400, {"error": f"bad request: {exc}"})
                except Exception:  # noqa: BLE001 — a server fault
                    logger.exception("generate failed")
                    self._reply(500, {"error": "internal server error"})

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

    # -- request handlers ---------------------------------------------------

    def _record(self, new_tokens: int, wall: float):
        with self._stats_lock:
            self.requests_served += 1
            self.tokens_emitted += new_tokens
            self.decode_seconds += wall

    def handle_generate(self, body: Dict[str, Any]) -> Dict[str, Any]:
        ids = [int(x) for x in body["input_ids"]]
        max_new = int(body.get("max_new_tokens",
                               self.default_max_new_tokens))
        stop = body.get("stop_token_ids")
        topk = int(body.get("topk", 1))
        decoder = self.decoder
        if topk > 1:
            raise ValueError(
                f"topk={topk}: {TREE_LATER}" if hasattr(decoder, "k") else
                f"topk={topk}: a block decoder proposes one block a round")
        t0 = time.monotonic()
        with self._device_lock:
            if body.get("plain"):
                out = fused_plain_decode(
                    decoder.target_params, decoder.target_config, ids,
                    max_new_tokens=max_new, max_len=decoder.max_len,
                    stop_token_ids=stop, loop_cache=decoder.plain_loops)
                wall = time.monotonic() - t0
                new = len(out) - len(ids)
                self._record(new, wall)
                return {"output_ids": [int(x) for x in out],
                        "new_tokens": new,
                        "wall_ms": round(wall * 1e3, 2)}
            result = decoder.generate_fused(ids, max_new_tokens=max_new,
                                            stop_token_ids=stop)
        wall = time.monotonic() - t0
        new = len(result.output_ids) - len(ids)
        self._record(new, wall)
        return {
            "output_ids": [int(x) for x in result.output_ids],
            "new_tokens": new,
            "accept_lengths": [int(a) for a in result.accept_lengths],
            "mean_accept_length": round(result.mean_accept_length, 4),
            "rounds": result.steps,
            "wall_ms": round(wall * 1e3, 2),
        }

    def handle_generate_batch(self, body: Dict[str, Any]) -> Dict[str, Any]:
        raise ValueError(f"/generate_batch: {BATCH_LATER}")

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        logger.info("serving server listening on :%d", self.port)

    def stop(self):
        self.httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.httpd.server_close()
