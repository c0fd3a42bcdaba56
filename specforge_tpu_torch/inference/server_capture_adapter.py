"""Producer-side adapter to a running capture server.

Counterpart of ``specforge_tpu/inference/server_capture_adapter.py``:
builds ``/generate`` and ``/generate_batch`` requests with the
``spec_capture`` sink and turns ``meta_info.spec_capture`` responses into
SampleRefs ready to commit. With the store sink the tensors never touch
this process (server → network store); the inline sink decodes them into
CPU ``torch`` tensors for a local store.
"""

from __future__ import annotations

import base64
import json
import urllib.request
from typing import Any, Dict, List, Optional

import torch

from specforge_tpu_torch.runtime.contracts import (
    FeatureSpec,
    PromptTask,
    SampleRef,
)

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "int64": torch.int64,
    "int32": torch.int32,
    "float32": torch.float32,
}


class HTTPCaptureAdapter:
    def __init__(
        self,
        server_url: str,
        *,
        store=None,
        store_endpoint: Optional[str] = None,
        generation: int = 0,
        timeout: float = 120.0,
    ) -> None:
        """``store``: a NetworkFeatureStore (store sink: server-side writes +
        adopt()) or any FeatureStore (inline sink: tensors come back over HTTP
        and are put locally)."""
        self.server_url = server_url.rstrip("/")
        self.store = store
        self.store_endpoint = store_endpoint
        self.generation = generation
        self.timeout = timeout

    def _post(
        self, body: Dict[str, Any], path: str = "/generate"
    ) -> Dict[str, Any]:
        data = json.dumps(body).encode()
        req = urllib.request.Request(
            f"{self.server_url}{path}", data=data,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def healthy(self) -> bool:
        try:
            req = urllib.request.Request(f"{self.server_url}/health")
            with urllib.request.urlopen(req, timeout=5) as resp:
                return json.loads(resp.read()).get("status") == "ok"
        except Exception:  # noqa: BLE001 — health probe
            return False

    def produce_refs(self, task: PromptTask) -> List[SampleRef]:
        """Capture one prompt; returns refs whose tensors are already stored."""
        payload = dict(task.payload)
        body: Dict[str, Any] = {
            "input_ids": payload["input_ids"],
            "loss_mask": payload.get("loss_mask"),
            "sample_id": task.prompt_id,
        }
        use_store = self.store_endpoint is not None
        body["spec_capture"] = (
            {
                "sink": "store",
                "store": self.store_endpoint,
                "generation": self.generation,
            }
            if use_store
            else {"sink": "inline"}
        )
        response = self._post(body)
        spec = response["meta_info"]["spec_capture"]
        return [self._ref_from_spec(task, spec, use_store)]

    def produce_refs_batch(
        self, tasks: List[PromptTask]
    ) -> List[SampleRef]:
        """One ``/generate_batch`` request for a token-budget batch of tasks
        (reference TargetBatchPartition pairing, batch_partition.py:20)."""
        if not tasks:
            return []
        use_store = self.store_endpoint is not None
        body = {
            "samples": [
                {
                    "input_ids": t.payload["input_ids"],
                    "loss_mask": t.payload.get("loss_mask"),
                    "sample_id": t.prompt_id,
                }
                for t in tasks
            ],
            "spec_capture": (
                {
                    "sink": "store",
                    "store": self.store_endpoint,
                    "generation": self.generation,
                }
                if use_store
                else {"sink": "inline"}
            ),
        }
        response = self._post(body, path="/generate_batch")
        refs = []
        for task, result in zip(tasks, response["results"]):
            spec = result["meta_info"]["spec_capture"]
            refs.append(self._ref_from_spec(task, spec, use_store))
        return refs

    def _ref_from_spec(
        self, task: PromptTask, spec: Dict[str, Any], use_store: bool
    ) -> SampleRef:
        feature_meta = spec["features"]
        if use_store:
            specs = {
                name: FeatureSpec(
                    name=name, shape=tuple(m["shape"]), dtype=m["dtype"]
                )
                for name, m in feature_meta.items()
            }
            ref = self.store.adopt(
                task.prompt_id, specs,
                metadata={"target_repr": "hidden_state"},
            )
        else:
            tensors = {}
            for name, m in feature_meta.items():
                raw = bytearray(base64.b64decode(spec["data"][name]))
                tensors[name] = torch.frombuffer(
                    raw, dtype=_DTYPES[m["dtype"]]
                ).reshape(m["shape"])
            ref = self.store.put_sample(
                task.prompt_id, tensors,
                metadata={"target_repr": "hidden_state"},
            )
        return SampleRef(
            sample_id=ref.sample_id,
            features=ref.features,
            prompt_id=task.prompt_id,
            epoch=task.epoch,
            metadata=ref.metadata,
        )
