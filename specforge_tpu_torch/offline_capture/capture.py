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

On a capture mesh (:func:`build_capture_mesh`: one process per rank, a
1-D ``fsdp`` mesh) the target's parameters are sharded over the ranks
(``models/target/sharding.py``) and every rank runs every batch; MoE
targets may keep their experts sharded (``moe_impl="ep"``) with a
capacity factor, and the runner aborts when an assignment overflowed.
Only rank 0 writes files.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from specforge_tpu_torch.models.target.sharding import ShardedParams
from specforge_tpu_torch.models.target.transformer import (
    TargetConfig,
    check_moe_impl,
    load_target_params,
    target_capture_forward,
)
from specforge_tpu_torch.parallel import multihost
from specforge_tpu_torch.parallel.mesh import Mesh, MeshConfig, build_mesh
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


def build_capture_mesh(n_devices: int = 0, device: DeviceLike = None
                       ) -> Mesh:
    """This rank's place on a 1-D ``fsdp`` capture mesh of ``n_devices``
    ranks (0: every rank of the group), the counterpart of the JAX
    package's mesh over local devices (``specforge_tpu/offline_capture/
    capture.py:57-68``). The default process group is made here from the
    ``SPECFORGE_*`` env (``multihost.maybe_initialize_distributed`` picks
    the transport: NCCL with a card per rank, host-staged gloo when ranks
    share a card, gloo on the CPU); without it the mesh is this process
    alone. A mesh of another size than the group raises."""
    device = multihost.maybe_initialize_distributed(resolve_device(device))
    world = multihost.process_count()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a capture mesh of {n} ranks needs {n} processes, "
                         f"have {world}")
    return build_mesh(MeshConfig(fsdp=n), device)


class CapacityOverflow(RuntimeError):
    """Expert assignments no rank computed: the capture would be inexact.
    Every rank raises it after the same forward."""


class OfflineCaptureRunner:
    def __init__(
        self,
        config: OfflineCaptureConfig,
        *,
        target_config: Optional[TargetConfig] = None,
        target_params: Optional[Dict[str, torch.Tensor]] = None,
        mesh: Optional[Mesh] = None,
        moe_impl: str = "gathered",
        moe_capacity_factor: Optional[float] = None,
        device: DeviceLike = None,
    ) -> None:
        """The target's weights are loaded (or ``target_params`` taken) on
        one device, CUDA unless ``device`` names another, or on a capture
        ``mesh`` (:func:`build_capture_mesh`) this rank's shards on its
        device: each rank keeps its slice of every sharded leaf and runs
        every batch. ``moe_impl``: how an MoE target's layers combine their
        experts, ``gathered`` or ``dense``, or ``ep`` (needs a mesh): the
        expert tables stay sharded by expert and each rank computes its
        experts' rows, at most ``moe_capacity_factor``·rows/ep of them
        (default: all); the runner aborts when any assignment overflowed
        (the capture must be exact), so raise the factor then."""
        self.config = config
        if config.layout not in _LAYOUTS:
            raise ValueError(f"unknown layout {config.layout!r}")
        self.target_config = target_config or TargetConfig.from_file(
            config.target_model_path
        )
        check_moe_impl(moe_impl, self.target_config)
        if moe_impl == "ep":
            if mesh is None:
                raise ValueError("moe_impl='ep' requires a device mesh")
            if self.target_config.num_experts <= 0:
                raise ValueError("moe_impl='ep' needs an MoE target")
        self.moe_impl = moe_impl
        self.moe_capacity_factor = moe_capacity_factor
        self.mesh = mesh
        ep = moe_impl == "ep"
        if target_params is not None:
            if mesh is not None and not isinstance(target_params,
                                                   ShardedParams):
                raise ValueError(
                    "on a capture mesh, give this rank's shards "
                    "(load_target_params(..., mesh=mesh))")
            self.params = target_params
            self.device = next(iter(target_params.values())).device
        else:
            self.device = (mesh.device if mesh is not None
                           else resolve_device(device))
            self.params = load_target_params(
                config.target_model_path, self.target_config,
                device=self.device, mesh=mesh, expert_parallel=ep)

    @property
    def primary(self) -> bool:
        """Whether this process writes: rank 0, or the only process."""
        return self.mesh is None or self.mesh.rank == 0

    def _run_batch(self, input_ids: np.ndarray, attention_mask: np.ndarray
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One padded batch → (aux, last hidden) on the host."""
        stats: Dict[str, int] = {}
        aux, last = target_capture_forward(
            self.params, self.target_config,
            torch.as_tensor(input_ids, device=self.device),
            torch.as_tensor(attention_mask, device=self.device),
            tuple(self.config.capture_layers), moe_impl=self.moe_impl,
            mesh=self.mesh, moe_capacity_factor=self.moe_capacity_factor,
            stats=stats,
        )
        dropped = stats["moe_overflow"]
        if dropped:
            raise CapacityOverflow(
                f"EP MoE capacity overflow: {dropped} expert assignments "
                f"were not computed — capture would be inexact. Raise "
                f"moe_capacity_factor (or use the default full capacity).")
        return aux.cpu(), last.cpu()

    def run(
        self,
        samples: Iterable[Dict[str, np.ndarray]],
        *,
        sample_ids: Optional[Sequence[str]] = None,
    ) -> List[str]:
        """``samples``: dicts with ``input_ids`` [S] and ``loss_mask`` [S].
        Returns the written file paths: on a mesh rank 0 writes them and
        every rank returns the same list, after a barrier."""
        cfg = self.config
        if self.primary:
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
                if self.primary:
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
        if self.mesh is not None:
            multihost.barrier("capture written")
        logger.info("captured %d samples into %s", len(written),
                    cfg.output_dir)
        return written
