"""Offline feature capture: target prefill → per-sample feature files.

Counterpart of ``specforge_tpu/offline_capture/capture.py``: runs the
frozen target's prefill (``models/target/transformer.py``, every family of
the JAX package, MoE targets with ``moe_impl`` ``gathered`` or ``dense``)
over the tokenised dataset on one device, CUDA unless the caller names
another, captures the algorithm's feature layout (EAGLE family: the 3-layer
aux concat as ``hidden_state`` and ``target`` = the post-norm last hidden;
DFlash family: the N-layer concat as ``hidden_states`` and
``target_last_hidden_states``), and writes one ``.sft`` per sample with the
JAX runner's metadata. Batches are padded to a static ``max_length`` and
``batch_size`` rows, as in the JAX package; features are trimmed back to
each sample's true length before writing.

A capture mesh and EP MoE are refused by name: the port captures on one
device (``ROADMAP.md`` Queue 1 item 7d).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from specforge_tpu_torch.models.target.transformer import (
    EP_LATER,
    TargetConfig,
    check_moe_impl,
    load_target_params,
    target_capture_forward,
)
from specforge_tpu_torch.runtime.data_plane.feature_file import save_feature_file
from specforge_tpu_torch.utils import DeviceLike, resolve_device

logger = logging.getLogger("specforge_tpu_torch.capture")


@dataclass(frozen=True)
class OfflineCaptureConfig:
    target_model_path: str
    output_dir: str
    capture_layers: Tuple[int, ...]
    max_length: int = 2048
    batch_size: int = 4
    #: feature layout: eagle ("hidden_state"/"target") or dflash
    #: ("hidden_states"/"target_last_hidden_states")
    layout: str = "eagle"
    store_dtype: str = "bfloat16"


_LAYOUTS = {
    "eagle": ("hidden_state", "target"),
    "dflash": ("hidden_states", "target_last_hidden_states"),
}


class OfflineCaptureRunner:
    def __init__(
        self,
        config: OfflineCaptureConfig,
        *,
        target_config: Optional[TargetConfig] = None,
        target_params: Optional[Dict[str, torch.Tensor]] = None,
        mesh=None,
        moe_impl: str = "gathered",
        device: DeviceLike = None,
    ) -> None:
        """The target's weights are loaded (or ``target_params`` taken) on
        one device: CUDA unless ``device`` names another. ``moe_impl``:
        how an MoE target's layers combine their experts, ``gathered`` or
        ``dense`` (``ep`` is refused)."""
        if mesh is not None:
            raise NotImplementedError(f"a capture mesh: {EP_LATER}")
        check_moe_impl(moe_impl)
        self.moe_impl = moe_impl
        self.config = config
        if config.layout not in _LAYOUTS:
            raise ValueError(f"unknown layout {config.layout!r}")
        self.target_config = target_config or TargetConfig.from_file(
            config.target_model_path
        )
        if target_params is not None:
            self.params = target_params
            self.device = next(iter(target_params.values())).device
        else:
            self.device = resolve_device(device)
            self.params = load_target_params(
                config.target_model_path, self.target_config,
                device=self.device)

    def _run_batch(self, input_ids: np.ndarray, attention_mask: np.ndarray
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One padded batch → (aux, last hidden) on the host."""
        aux, last = target_capture_forward(
            self.params, self.target_config,
            torch.as_tensor(input_ids, device=self.device),
            torch.as_tensor(attention_mask, device=self.device),
            tuple(self.config.capture_layers), moe_impl=self.moe_impl,
        )
        return aux.cpu(), last.cpu()

    def run(
        self,
        samples: Iterable[Dict[str, np.ndarray]],
        *,
        sample_ids: Optional[Sequence[str]] = None,
    ) -> List[str]:
        """``samples``: dicts with ``input_ids`` [S] and ``loss_mask`` [S].
        Returns the written file paths."""
        cfg = self.config
        os.makedirs(cfg.output_dir, exist_ok=True)
        aux_name, last_name = _LAYOUTS[cfg.layout]
        store_dtype = getattr(torch, cfg.store_dtype)
        metadata = {
            "target_repr": "hidden_state",
            "capture_layers": ",".join(str(i) for i in cfg.capture_layers),
            "layout": cfg.layout,
        }

        written: List[str] = []
        batch: List[Tuple[str, np.ndarray, np.ndarray]] = []

        def flush():
            if not batch:
                return
            ids = np.zeros((cfg.batch_size, cfg.max_length), np.int64)
            mask = np.zeros((cfg.batch_size, cfg.max_length), np.int64)
            for j, (_sid, s_ids, _lm) in enumerate(batch):
                n = min(len(s_ids), cfg.max_length)
                ids[j, :n] = s_ids[:n]
                mask[j, :n] = 1
            aux, last = self._run_batch(ids, mask)
            for j, (sid, s_ids, s_lm) in enumerate(batch):
                n = min(len(s_ids), cfg.max_length)
                tensors = {
                    "input_ids": torch.as_tensor(
                        np.asarray(s_ids[:n], np.int64)),
                    "loss_mask": torch.as_tensor(
                        np.asarray(s_lm[:n], np.int64)),
                    aux_name: aux[j, :n].to(store_dtype),
                    last_name: last[j, :n].to(store_dtype),
                }
                path = os.path.join(cfg.output_dir, f"{sid}.sft")
                save_feature_file(path, tensors, metadata)
                written.append(path)
            batch.clear()

        for i, sample in enumerate(samples):
            sid = (sample_ids[i] if sample_ids is not None
                   else f"sample-{i:06d}")
            batch.append(
                (sid, np.asarray(sample["input_ids"]).reshape(-1),
                 np.asarray(sample["loss_mask"]).reshape(-1))
            )
            if len(batch) == cfg.batch_size:
                flush()
        flush()
        logger.info("captured %d samples into %s", len(written),
                    cfg.output_dir)
        return written
