"""Network feature store client: the cross-host tensor plane.

Counterpart of ``specforge_tpu/runtime/data_plane/network_store.py``: a
client of the repository's C++ host-RAM object store,
``cpp/feature_store_server.cpp``, over its length-prefixed binary protocol
(see the server source for the wire format): raw-buffer puts with shape and
dtype carried by the SampleRef, hard-pinned objects with the trainer as
lifetime authority, retryable removals (``drain_pending_removals``), and
``adopt()`` for objects a capture server wrote itself. bf16 travels as its
raw little-endian 2-byte patterns under the dtype name ``"bfloat16"``;
fetches land in CPU ``torch`` tensors.

Object keys: ``{sample_id}/{feature_name}.g{generation}``.

:func:`server_binary` builds the server from that source with ``g++`` at
first use, into ``specforge_tpu_torch/_build/`` (a digest of the source in
the file name), and returns its path.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import socket
import struct
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch

from specforge_tpu_torch.runtime.contracts import (
    FeatureHandle,
    FeatureSpec,
    SampleRef,
)
from specforge_tpu_torch.runtime.data_plane.feature_store import (
    FeatureStore,
    StaleReferenceError,
    StoreError,
)

REPO = Path(__file__).resolve().parents[3]
SERVER_SOURCE = REPO / "cpp" / "feature_store_server.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-pthread")

_TORCH_DTYPES = {
    "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float16": torch.float16, "float64": torch.float64,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "uint16": torch.uint16,
    "uint32": torch.uint32, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}
_build_lock = threading.Lock()


def server_path() -> Path:
    """Where :func:`server_binary` puts the server built from this
    checkout's source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SERVER_SOURCE.read_bytes())
    return BUILD_DIR / f"feature_store_server-{h.hexdigest()[:16]}"


def server_binary() -> Path:
    """The store server, compiled from ``cpp/feature_store_server.cpp``
    with ``g++`` on first use (per-process temporary, atomic rename); a
    failed build raises with the compiler's log."""
    path = server_path()
    with _build_lock:
        if path.exists():
            return path
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            raise RuntimeError(
                "g++ not found: the feature store server is built from "
                f"{SERVER_SOURCE} at first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SERVER_SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the feature store server failed:\n{proc.stdout}")
        os.replace(tmp, path)
        return path


def _byte_view(t: torch.Tensor) -> memoryview:
    """Raw bytes of a contiguous CPU tensor of any dtype (bf16 too)."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


class AuthError(StoreError):
    pass


class _Connection:
    def __init__(self, host: str, port: int, timeout: float,
                 secret: Optional[str] = None):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if secret:
            status, _ = self.request(b"A", "", secret.encode())
            if status != 0:
                raise AuthError("feature store rejected the shared secret")

    def _send_request(self, op: bytes, key: str, payload) -> None:
        key_b = key.encode()
        header = op + struct.pack("<I", len(key_b)) + key_b + struct.pack(
            "<Q", len(payload) if payload is not None else 0)
        self.sock.sendall(header)
        if payload is not None and len(payload):
            # a memoryview: no copy of a large tensor
            self.sock.sendall(payload)

    def request(self, op: bytes, key: str, payload=b"") -> Tuple[int, bytes]:
        self._send_request(op, key, payload)
        status, resp_len = self._read_header()
        body = self._read_exact(resp_len) if resp_len else b""
        return status, body

    def request_into(self, op: bytes, key: str, out: memoryview) -> int:
        """GET streaming the response into a preallocated buffer."""
        self._send_request(op, key, None)
        status, resp_len = self._read_header()
        if status != 0:
            if resp_len:
                self._read_exact(resp_len)
            return status
        if resp_len != len(out):
            # drain to keep the connection usable, then fail loudly
            self._read_exact(resp_len)
            raise StoreError(
                f"object {key}: size {resp_len} != buffer {len(out)}")
        self._read_exact_into(out)
        return status

    def _read_header(self) -> Tuple[int, int]:
        status_len = self._read_exact(9)
        (resp_len,) = struct.unpack("<Q", status_len[1:9])
        return int(status_len[0:1].decode()), resp_len

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray(n)
        self._read_exact_into(memoryview(buf))
        return bytes(buf)

    def _read_exact_into(self, view: memoryview) -> None:
        remaining = len(view)
        offset = 0
        while remaining:
            r = self.sock.recv_into(view[offset:], remaining)
            if r <= 0:
                raise ConnectionError("feature store connection closed")
            offset += r
            remaining -= r

    def close(self):
        try:
            self.sock.sendall(b"Q")
        except OSError:
            pass
        self.sock.close()


def _key_of(handle: FeatureHandle) -> str:
    return handle.uri.split("/", 3)[3]  # net://host:port/<key>


class NetworkFeatureStore(FeatureStore):
    def __init__(
        self,
        endpoint: str,
        *,
        generation: int = 0,
        timeout: float = 30.0,
        secret: Optional[str] = None,
    ) -> None:
        host, _, port = endpoint.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.timeout = timeout
        self.generation = generation
        self.secret = (secret if secret is not None
                       else os.environ.get("SPECFORGE_STORE_SECRET"))
        self._local = threading.local()
        self._pending_removals: List[str] = []
        self._pending_lock = threading.Lock()
        self._adopted_bytes = 0
        #: bytes this client fetched (every feature of every ref)
        self.fetched_bytes = 0

    def _conn(self) -> _Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = _Connection(self.host, self.port, self.timeout,
                               secret=self.secret)
            self._local.conn = conn
        return conn

    def _key(self, sample_id: str, name: str, generation=None) -> str:
        gen = self.generation if generation is None else generation
        return f"{sample_id}/{name}.g{gen}"

    # --- FeatureStore contract -------------------------------------------
    def put_sample(self, sample_id, tensors: Mapping[str, torch.Tensor],
                   metadata=None) -> SampleRef:
        conn = self._conn()
        features: Dict[str, FeatureHandle] = {}
        for name, arr in tensors.items():
            t = torch.as_tensor(arr).contiguous()
            key = self._key(sample_id, name)
            status, _ = conn.request(b"P", key, _byte_view(t))
            if status == 2:
                raise MemoryError(
                    f"network feature store over budget putting {key}; "
                    "producer flow control should have paused upstream")
            if status != 0:
                raise StoreError(f"put {key} failed with status {status}")
            features[name] = FeatureHandle(
                uri=f"net://{self.host}:{self.port}/{key}",
                spec=FeatureSpec(name=name, shape=tuple(t.shape),
                                 dtype=_NAMES[t.dtype]),
            )
        return SampleRef(sample_id=sample_id, features=features,
                         metadata=dict(metadata or {}))

    def fetch(self, ref: SampleRef) -> Dict[str, torch.Tensor]:
        """GET each feature straight into a new tensor of its final shape
        and dtype (no intermediate bytes buffer)."""
        out: Dict[str, torch.Tensor] = {}
        for name, handle in ref.features.items():
            t = torch.empty(handle.spec.shape,
                            dtype=_TORCH_DTYPES[handle.spec.dtype])
            self.fetch_feature_into(handle, t)
            out[name] = t
        return out

    def fetch_feature_into(self, handle: FeatureHandle,
                           out: torch.Tensor) -> None:
        """Stream one object into a preallocated contiguous CPU tensor."""
        key = _key_of(handle)
        status = self._conn().request_into(b"G", key, _byte_view(out))
        if status == 1:
            raise StaleReferenceError(
                f"object {key} not in store (released or stale generation)")
        if status != 0:
            raise StoreError(f"get {key} failed with status {status}")
        self.fetched_bytes += out.numel() * out.element_size()

    def release(self, sample_ids: Iterable[str]) -> None:
        raise StoreError(
            "NetworkFeatureStore requires release_refs(refs): object keys "
            "carry feature names")

    def release_refs(self, refs: Iterable[SampleRef]) -> None:
        conn = self._conn()
        for ref in refs:
            for handle in ref.features.values():
                key = _key_of(handle)
                try:
                    status, _ = conn.request(b"D", key)
                    # pinned: the lifetime authority unpins until removable
                    # (pin counts can exceed 1 after crash-readopt cycles)
                    attempts = 0
                    while status == 5 and attempts < 64:
                        conn.request(b"U", key)
                        status, _ = conn.request(b"D", key)
                        attempts += 1
                    if status == 5:
                        with self._pending_lock:
                            self._pending_removals.append(key)
                except (OSError, ConnectionError):
                    with self._pending_lock:
                        self._pending_removals.append(key)

    # --- pins and GC ------------------------------------------------------
    def pin_refs(self, refs: Iterable[SampleRef]) -> None:
        conn = self._conn()
        for ref in refs:
            for handle in ref.features.values():
                conn.request(b"I", _key_of(handle))

    def unpin_refs(self, refs: Iterable[SampleRef]) -> None:
        conn = self._conn()
        for ref in refs:
            for handle in ref.features.values():
                conn.request(b"U", _key_of(handle))

    def gc_sweep(self, max_age_seconds: int) -> int:
        """Server-side max-hold sweep: delete UNPINNED objects untouched for
        longer than ``max_age_seconds``; returns the number removed."""
        status, body = self._conn().request(
            b"C", "", struct.pack("<Q", int(max_age_seconds)))
        if status != 0:
            raise StoreError(f"gc sweep failed with status {status}")
        return int(json.loads(body.decode())["removed"])

    def drain_pending_removals(self) -> int:
        """Retry the removals that failed on a dead connection."""
        with self._pending_lock:
            pending, self._pending_removals = self._pending_removals, []
        self._local.conn = None  # reconnect
        conn = self._conn()
        failed = []
        for key in pending:
            try:
                conn.request(b"D", key)
            except (OSError, ConnectionError):
                failed.append(key)
        with self._pending_lock:
            self._pending_removals.extend(failed)
        return len(pending) - len(failed)

    def adopt(self, sample_id: str, specs: Mapping[str, FeatureSpec],
              metadata=None) -> SampleRef:
        """A ref for objects a capture server already wrote into the store;
        claiming them hard-pins them (the trainer is now their lifetime
        authority, and the max-hold sweep skips them)."""
        features = {
            name: FeatureHandle(
                uri=f"net://{self.host}:{self.port}/"
                    f"{self._key(sample_id, name)}",
                spec=spec)
            for name, spec in specs.items()
        }
        ref = SampleRef(sample_id=sample_id, features=features,
                        metadata=dict(metadata or {}))
        self._adopted_bytes += ref.nbytes
        try:
            self.pin_refs([ref])
        except (OSError, ConnectionError, StoreError):
            pass  # the pin protects; it is not needed for correctness
        return ref

    def health(self) -> Dict[str, Any]:
        status, body = self._conn().request(b"S", "")
        if status != 0:
            return {"backend": "network", "error": f"stat status {status}"}
        out = json.loads(body.decode())
        out["backend"] = "network"
        out["endpoint"] = f"{self.host}:{self.port}"
        with self._pending_lock:
            out["pending_removals"] = len(self._pending_removals)
        return out

    def close(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
