"""Trainer: lifecycle orchestration around the train step, on one device.

Counterpart of ``specforge_tpu/training/trainer.py``: loader → accumulation
grouping → train step → logging/eval/checkpointing, with mid-epoch
seek/resume and perf counters. The model lives in the strategy (its
parameters on its device); each micro-batch moves there inside the
strategy. In a multi-process run (``mesh``: dp, fsdp, USP or a mix) each
rank loads its batch block's rows of every global batch (the ranks of a
sequence group the same samples) and runs the same steps; the trainer
shards the model and its state over fsdp (``parallel/fsdp.py``), the train
step sums the gradients over the ranks, the primary rank writes whole
checkpoints and markers between barriers (the tracker of the other ranks
is a no-op), and every rank restores its slices on resume. Progress counts
samples of the global batch and the resume contract holds the global
batch, so a checkpoint moves between topologies. An online run's loader
streams its refs, and ``ack_fn(sample_ids, step)`` runs after each
optimizer step's checkpoint block, so that durable acknowledgements never
run ahead of the restorable state; its time goes into the perf record.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from specforge_tpu_torch.eval.evaluator import Evaluator
from specforge_tpu_torch.parallel.fsdp import ShardPlan
from specforge_tpu_torch.parallel.multihost import (
    barrier,
    is_primary,
    process_count,
)
from specforge_tpu_torch.runtime.contracts import TrainBatch
from specforge_tpu_torch.training.checkpoint import (
    CheckpointManager,
    Progress,
    ResumeContract,
)
from specforge_tpu_torch.training.optimizer import (
    OptimizerConfig,
    build_lr_schedule,
    build_optimizer,
)
from specforge_tpu_torch.training.profiling import (
    PerfCounters,
    ProfilingConfig,
    StepProfiler,
)
from specforge_tpu_torch.training.tracking import NoOpTracker, Tracker
from specforge_tpu_torch.training.train_step import (
    SparseEmbedPlan,
    TrainState,
    make_train_step,
)

logger = logging.getLogger("specforge_tpu_torch.trainer")


@dataclass
class TrainerConfig:
    num_epochs: int = 1
    accum_steps: int = 1
    #: gradient storage dtype between backward and the optimizer
    grads_dtype: str = "float32"
    #: cast fp32 masters to this dtype once per micro-step instead of per
    #: use (see make_train_step(compute_params_dtype))
    compute_params_dtype: Optional[str] = None
    log_interval: int = 10
    eval_interval: int = 0          # optimizer steps; 0 = end of epoch only
    checkpoint_interval: int = 0    # optimizer steps; 0 = end of epoch only
    max_checkpoints: int = 5
    output_dir: str = "runs"
    run_id: str = "run"
    resume: bool = False
    #: explicit resume target (step dir or run root): full restore under
    #: the resume contract
    resume_from: Optional[str] = None
    total_steps: Optional[int] = None  # resolved from data when None
    profiling: ProfilingConfig = field(default_factory=ProfilingConfig)


class Trainer:
    def __init__(
        self,
        strategy,
        *,
        train_loader,
        config: TrainerConfig,
        optimizer_config: OptimizerConfig,
        eval_loader=None,
        frozen: Optional[Dict[str, torch.Tensor]] = None,
        tracker: Optional[Tracker] = None,
        trainable_mask: Optional[Dict[str, bool]] = None,
        metadata: Optional[Dict[str, Any]] = None,
        contract_fingerprints: Optional[Dict[str, Any]] = None,
        mesh=None,
        ack_fn: Optional[Callable[[List[str], int], None]] = None,
    ) -> None:
        self.strategy = strategy
        self.ack_fn = ack_fn
        self.mesh = mesh
        #: the loader's batch is this block's rows of a global batch
        self.batch_blocks = mesh.config.batch_blocks if mesh else 1
        self.shards = None
        if mesh is not None and mesh.world_size > 1:
            self.shards = ShardPlan(strategy.model, mesh)
            self.shards.shard_model_(strategy.model)
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.config = config
        self.frozen = dict(frozen or {})
        self.tracker = tracker or NoOpTracker()
        self.metadata = dict(metadata or {})
        self.contract_fingerprints = dict(contract_fingerprints or {})

        if config.total_steps is None:
            try:
                per_epoch = len(train_loader) // config.accum_steps
            except TypeError as e:
                raise ValueError(
                    "total_steps must be given for streaming loaders") from e
            config.total_steps = per_epoch * config.num_epochs
        self.total_steps = config.total_steps

        self.optimizer = build_optimizer(optimizer_config, self.total_steps)
        self.lr_schedule = build_lr_schedule(optimizer_config, self.total_steps)
        self.sparse_plan = None
        if optimizer_config.row_sparse_embedding:
            path = getattr(strategy, "sparse_embed_path", None)
            shape_fn = getattr(strategy, "sparse_embed_delta_shape", None)
            if path is None or shape_fn is None:
                raise ValueError(
                    "optimizer.row_sparse_embedding requires a strategy that "
                    "declares sparse_embed_path and sparse_embed_delta_shape "
                    f"(strategy {getattr(strategy, 'name', strategy)!r} does "
                    "not)"
                )
            self.sparse_plan = SparseEmbedPlan(path, shape_fn,
                                               optimizer_config,
                                               self.lr_schedule)
        self.state = TrainState.create(
            strategy.model, self.optimizer, trainable_mask,
            sparse_embed_path=(self.sparse_plan.path if self.sparse_plan
                               else None),
            shards=self.shards)
        self.train_step = make_train_step(
            strategy,
            self.optimizer,
            accum_steps=config.accum_steps,
            total_steps=self.total_steps,
            metadata=self.metadata,
            lr_schedule=self.lr_schedule,
            grads_dtype=config.grads_dtype,
            compute_params_dtype=config.compute_params_dtype,
            sparse_embed=self.sparse_plan,
            mesh=mesh,
            shards=self.shards,
        )
        self.checkpoints = CheckpointManager(
            config.output_dir, config.run_id,
            max_checkpoints=config.max_checkpoints,
            primary=is_primary(), barrier_fn=barrier,
        )
        self.evaluator = Evaluator(strategy, self.metadata)
        self.profiler = StepProfiler(config.profiling, config.run_id)
        self.progress = Progress()
        self._saved_step: Optional[int] = None  # the last state written

    # --- contract --------------------------------------------------------
    def resume_contract(self) -> ResumeContract:
        """The run's contract; the batch is the global one, and the world
        size, which may differ, is not compared on resume."""
        return ResumeContract(
            strategy=self.strategy.name,
            world_size=process_count(),
            train_batch_size=getattr(self.train_loader, "batch_size", 0)
            * self.batch_blocks,
            accum_steps=self.config.accum_steps,
            total_steps=self.total_steps,
            run_id=self.config.run_id,
            draft_config_fingerprint=self.contract_fingerprints.get(
                "draft_config_fingerprint", ""
            ),
            model_fingerprints=self.contract_fingerprints.get(
                "model_fingerprints", {}
            ),
        )

    def _accum_groups(self, loader) -> Iterable[tuple]:
        """Group ``accum_steps`` consecutive TrainBatch into one [A, B, ...]
        stacked host batch; a trailing partial window is dropped."""
        window: List[TrainBatch] = []
        for batch in loader:
            window.append(batch)
            if len(window) == self.config.accum_steps:
                stacked = {
                    k: torch.stack([b.tensors[k] for b in window])
                    for k in window[0].tensors
                }
                sample_ids = [sid for b in window for sid in b.sample_ids]
                # the packing counts are per-batch statistics, not options
                # of the step
                metadata = _step_metadata(window[0].metadata)
                for b in window[1:]:
                    if _step_metadata(b.metadata) != metadata:
                        raise ValueError(
                            "mixed metadata inside one accumulation window: "
                            f"{metadata} vs {b.metadata}"
                        )
                yield stacked, sample_ids, metadata
                window = []

    # --- main loop -------------------------------------------------------
    def fit(self) -> Dict[str, float]:
        cfg = self.config
        start_epoch = 0
        # this run's OWN latest checkpoint (when resume is on) wins over
        # resume_from, so a relaunch continues its own progress
        own_latest = self.checkpoints.latest_step() if cfg.resume else None
        if own_latest is not None:
            self._restore(own_latest)
            start_epoch = self.progress.epoch
        elif cfg.resume_from:
            self._restore(step_dir=self.checkpoints.resolve_step_dir(
                cfg.resume_from))
            start_epoch = self.progress.epoch

        perf = PerfCounters()
        last_metrics: Dict[str, float] = {}
        last_metrics_dev: Dict[str, Any] = {}
        try:
            for epoch in range(start_epoch, cfg.num_epochs):
                self.progress.epoch = epoch
                if getattr(self.train_loader, "supports_seek", False):
                    self.train_loader.seek(
                        self.progress.samples_consumed // self.batch_blocks
                        if epoch == start_epoch else 0
                    )
                if epoch != start_epoch:
                    self.progress.samples_consumed = 0

                data_t0 = time.monotonic()
                for stacked, sample_ids, _metadata in self._accum_groups(
                    self.train_loader
                ):
                    perf.data_wait_s += time.monotonic() - data_t0
                    step = self.state.step
                    self.profiler.on_step_begin(step)
                    t0 = time.monotonic()
                    self.state, metrics_dev = self.train_step(
                        self.state, stacked, self.frozen
                    )
                    perf.compute_s += time.monotonic() - t0
                    n_samples = len(sample_ids)
                    self.progress.samples_consumed += (n_samples
                                                       * self.batch_blocks)
                    self.progress.global_step = step + 1
                    perf.steps += 1
                    perf.samples += n_samples
                    self.profiler.on_step_end(step)
                    # metric tensors stay on the device until a boundary
                    # needs them: no host sync per step
                    last_metrics_dev = metrics_dev

                    new_step = step + 1
                    if cfg.log_interval and new_step % cfg.log_interval == 0:
                        last_metrics = _pull(last_metrics_dev)
                        metrics = dict(last_metrics)
                        metrics.update(perf.window_metrics())
                        self.tracker.log(metrics, new_step)
                        perf.reset()
                    if cfg.eval_interval and new_step % cfg.eval_interval == 0:
                        last_metrics = _pull(last_metrics_dev)
                        last_metrics.update(self._evaluate(new_step))
                        last_metrics_dev = last_metrics
                    if (cfg.checkpoint_interval
                            and new_step % cfg.checkpoint_interval == 0):
                        last_metrics = _pull(last_metrics_dev)
                        self._save(new_step, last_metrics)
                    if self.ack_fn is not None:
                        # after the checkpoint block: durable acks never run
                        # ahead of the restorable state
                        t0 = time.monotonic()
                        self.ack_fn(sample_ids, new_step)
                        perf.ack_s += time.monotonic() - t0
                    data_t0 = time.monotonic()

                # end of epoch: eval + checkpoint (progress records the NEXT
                # position so resume starts at the following epoch)
                last_metrics = _pull(last_metrics_dev)
                last_metrics.update(self._evaluate(self.state.step))
                last_metrics_dev = last_metrics
                self.progress.epoch = epoch + 1
                self.progress.samples_consumed = 0
                self._save(self.state.step, last_metrics)
        finally:
            self.profiler.finalize()
        return last_metrics

    # --- eval / checkpoint ----------------------------------------------
    def _evaluate(self, step: int) -> Dict[str, float]:
        if self.eval_loader is None:
            return {}
        params = (self.shards.whole_params(self.strategy.model)
                  if self.shards is not None and self.shards.sharded
                  else None)
        metrics = self.evaluator.run(self.eval_loader, self.frozen, params)
        del params
        if metrics:
            self.tracker.log(metrics, step)
        return metrics

    def _save(self, step: int, metrics: Dict[str, float]) -> None:
        if self._saved_step == step:
            # the interval's checkpoint of this step holds this state (an
            # epoch that ends on it): only its contract and progress change
            self.checkpoints.save_contract(
                step, self.resume_contract(), self.progress, metrics)
        else:
            gather = (self.shards.whole_state
                      if self.shards is not None and self.shards.sharded
                      else None)
            self.checkpoints.save(
                self.state, step, self.resume_contract(), self.progress,
                metrics, gather=gather,
            )
            self._saved_step = step
        self.checkpoints.maybe_update_best(step, metrics)

    @torch.no_grad()
    def _restore(self, step: Optional[int] = None, *,
                 step_dir: Optional[str] = None) -> None:
        if step_dir is not None:
            payload, progress, _ = self.checkpoints.restore_path(
                step_dir, contract=self.resume_contract())
        else:
            payload, progress, _ = self.checkpoints.restore(
                step, contract=self.resume_contract())
        shards = self.shards
        for group in ("params", "buffers"):
            live = getattr(self.state, group)
            saved = payload[group]
            if set(saved) != set(live):
                raise ValueError(
                    f"checkpoint {group} differ from the model's: "
                    f"{sorted(set(saved) ^ set(live))}"
                )
            for name, tensor in saved.items():
                if shards is not None and group == "params":
                    tensor = shards.local(tensor, shards.dim(name))
                live[name].copy_(tensor)
        saved = payload["opt_state"]
        if shards is not None:
            saved = shards.local_tree(saved)
        self.state.opt_state = _restore_tree(self.state.opt_state, saved)
        self.state.step = int(payload["step"])
        self.progress = progress
        logger.info(
            "resumed %s at step %s (epoch %d, samples %d)",
            self.config.run_id, step if step_dir is None else step_dir,
            progress.epoch, progress.samples_consumed,
        )


def _step_metadata(metadata: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in metadata.items() if k != "packing"}


def _restore_tree(live, saved, where: str = "opt_state"):
    """The saved optimizer state on the devices of the live one, which it
    must match in structure (a dense or a factored state, with or without
    the row-sparse embedding state)."""
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(
                f"checkpoint {where} differs from the optimizer's: saved "
                f"{sorted(saved) if isinstance(saved, dict) else saved!r}, "
                f"expected {sorted(live)}")
        return {k: _restore_tree(live[k], saved[k], f"{where}.{k}")
                for k in live}
    if isinstance(live, torch.Tensor):
        return saved.to(device=live.device, dtype=live.dtype)
    return type(live)(saved)


def _pull(metrics_dev: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics_dev.items()}
