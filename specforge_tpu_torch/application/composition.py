"""Composition root: Config → runnable training run.

Counterpart of ``specforge_tpu/application/composition.py`` for offline
runs of EAGLE3, the DFlash family (dflash, domino) and P-EAGLE: resolves the
algorithm registration, builds the draft, training model and strategy
through the providers, warm-starts the draft from
``model.draft_checkpoint_path`` when set, loads the frozen target tables
and the vocab mapping (from a file, or derived from the training
features), wires the loaders
(``PaddingCollator``, or ``PackingCollator`` under ``data.pack_documents``)
and the tracker, and returns the :class:`Trainer`. EAGLE3 copies the target
embedding into its draft and freezes it (the frozen table cast to bf16);
P-EAGLE copies it too but trains it in fp32; the DFlash family reads the
target head and embedding from ``frozen`` at every step and trains every
draft parameter. A run on a mesh of ``dp × fsdp × sp_ulysses × sp_ring``
ranks (``fsdp_size: 0`` takes the processes left over, as in the JAX
package; the sequence axes only under EAGLE3's ``attention_backend:
"usp"``) runs one process per rank, started with the multi-process env
(``parallel/multihost.py``): the rank grid and its groups first, then the
draft over them; the rank of batch block ``d·fsdp + f`` loads that
block's rows of every global batch (``training.batch_size`` is the global
batch), the ranks of one block (its sequence group) the same samples; the
primary rank derives the vocab mapping and owns the tracker. The trainer
shards the state over fsdp (``parallel/fsdp.py``). What the port has
not reached yet (online runs) is refused with the slice that brings it,
and an eval pass for the DFlash family and P-EAGLE, which their JAX
strategies do not define, is refused by name.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from specforge_tpu_torch.algorithms.builtin import builtin_algorithm_registry
from specforge_tpu_torch.algorithms.contracts import FeatureMode
from specforge_tpu_torch.algorithms.registry import AlgorithmRegistration
from specforge_tpu_torch.config.schema import Config
from specforge_tpu_torch.data.collator import (
    CollatorConfig,
    PackingCollator,
    PackingCollatorConfig,
    PaddingCollator,
)
from specforge_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from specforge_tpu_torch.parallel.multihost import (
    barrier,
    is_primary,
    maybe_initialize_distributed,
    process_count,
    shard_refs_for_process,
)
from specforge_tpu_torch.runtime.data_plane.feature_dataloader import (
    FeatureDataLoader,
)
from specforge_tpu_torch.runtime.data_plane.feature_store import FileFeatureStore
from specforge_tpu_torch.runtime.data_plane.offline_reader import (
    OfflineManifestReader,
)
from specforge_tpu_torch.training.model_loading import (
    draft_config_fingerprint,
    frozen_input_fingerprint,
    warm_start_draft,
)
from specforge_tpu_torch.training.optimizer import (
    OptimizerConfig,
    cast_frozen_to,
    embedding_freeze_mask,
)
from specforge_tpu_torch.training.profiling import ProfilingConfig
from specforge_tpu_torch.training.tracking import build_tracker
from specforge_tpu_torch.training.trainer import Trainer, TrainerConfig
from specforge_tpu_torch.training.vocab_mapping import (
    derive_from_offline_dir,
    load_vocab_mapping,
    save_vocab_mapping,
)
from specforge_tpu_torch.utils import DeviceLike, resolve_device

logger = logging.getLogger("specforge_tpu_torch.application")

@dataclass
class ResolvedRun:
    config: Config
    registration: AlgorithmRegistration
    draft_config_dict: Dict[str, Any]


def resolve_run(config: Config, registry=None) -> ResolvedRun:
    registry = registry or builtin_algorithm_registry()
    registration = registry.resolve(config.training.strategy)
    draft_config_dict = _load_draft_config_dict(config)
    arch = tuple(draft_config_dict.get("architectures") or ())
    if arch and not (
        set(arch) & registration.spec.draft.compatible_architectures
    ):
        logger.warning(
            "draft architectures %s not declared compatible with %s; "
            "building with the algorithm's default architecture",
            arch, registration.name,
        )
    return ResolvedRun(config=config, registration=registration,
                       draft_config_dict=draft_config_dict)


def _load_draft_config_dict(config: Config) -> Dict[str, Any]:
    if config.model.draft_config is not None:
        return dict(config.model.draft_config)
    if config.model.draft_config_path:
        with open(config.model.draft_config_path) as f:
            return json.load(f)
    raise ValueError(
        "model.draft_config or model.draft_config_path is required"
    )


def _refuse_unported(config: Config) -> None:
    """Raise for what a config asks of slices the port has not reached."""
    t = config.training
    if config.deployment.mode != "colocated" or t.role not in ("all", "auto"):
        raise NotImplementedError(
            "online (disaggregated) runs come with the capture and online "
            "slice (ROADMAP.md, Queue 1 item 7)"
        )
    if t.attention_backend == "usp" and t.strategy != "eagle3":
        raise NotImplementedError(
            f"attention_backend='usp' is EAGLE3's; {t.strategy!r} has no "
            "sequence-parallel path, in the JAX package or the port"
        )


def _strategy_options(config: Config) -> Dict[str, Any]:
    t = config.training
    return {
        # eagle3
        "ttt_length": t.ttt_length,
        "ploss_decay": t.ploss_decay,
        "lk_loss_type": t.lk_loss_type,
        "kl_scale": t.kl_scale,
        "kl_decay": t.kl_decay,
        "compact_teacher": t.compact_teacher,
        "compact_teacher_chunk_size": t.compact_teacher_chunk_size,
        # dflash family
        "num_anchors": t.num_anchors,
        "loss_decay_gamma": t.loss_decay_gamma,
        "objective_chunk_blocks": t.objective_chunk_blocks,
        "fused_vocab_objective": t.fused_vocab_objective,
        "loss_type": t.loss_type,
        "dpace_alpha": t.dpace_alpha,
        "lambda_start": t.lambda_base_start,
        "decay_ratio": t.lambda_base_decay_ratio,
        "dspark_ce_loss_alpha": t.dspark_ce_loss_alpha,
        "dspark_l1_loss_alpha": t.dspark_l1_loss_alpha,
        "dspark_confidence_head_alpha": t.dspark_confidence_head_alpha,
        "mask_token_id": t.mask_token_id,
        # peagle
        "num_depths": t.num_depths,
        "down_sample_ratio": t.down_sample_ratio,
        "down_sample_ratio_min": t.down_sample_ratio_min,
        "seed": t.seed,
    }


def _load_target_tables(config: Config) -> Dict[str, torch.Tensor]:
    """Frozen target lm_head and embedding weights as bf16 CPU tensors."""
    from specforge_tpu_torch.models.target.head import TargetHead

    path = config.model.target_model_path
    if path is None:
        return {}
    return {
        name: TargetHead.from_pretrained(path, lm_head_key=key).weight
        for name, key in (("target_head_weight", config.model.lm_head_key),
                          ("target_embed_weight", config.model.embed_key))
    }


def _resolve_vocab_mapping(config: Config, draft_config) -> Optional[tuple]:
    draft_vocab = getattr(draft_config, "draft_vocab_size", None)
    vocab = getattr(draft_config, "vocab_size", None)
    if not draft_vocab or draft_vocab >= (vocab or 0):
        return None
    if config.model.vocab_mapping_path:
        return load_vocab_mapping(config.model.vocab_mapping_path)
    if config.data.train_data_path:
        cache = os.path.join(
            config.output_dir, f"{config.run_id}.vocab_mapping.npz"
        )
        if process_count() <= 1:
            if os.path.exists(cache):
                return load_vocab_mapping(cache)
            return _derive_vocab_mapping(config, cache, vocab, draft_vocab)
        # several ranks: the primary derives and writes the shared cache;
        # every rank passes the barrier, whatever the cache's timing
        if is_primary() and not os.path.exists(cache):
            _derive_vocab_mapping(config, cache, vocab, draft_vocab)
        barrier("vocab-mapping")
        return load_vocab_mapping(cache)
    return None


def _derive_vocab_mapping(config: Config, cache: str, vocab: int,
                          draft_vocab: int) -> tuple:
    logger.info("deriving vocab mapping from %s", config.data.train_data_path)
    t2d, d2t = derive_from_offline_dir(
        config.data.train_data_path, vocab, draft_vocab
    )
    os.makedirs(config.output_dir, exist_ok=True)
    save_vocab_mapping(cache, t2d, d2t)
    return t2d, d2t


def mesh_config(config: Config, procs: int) -> MeshConfig:
    """The rank grid of a run on ``procs`` processes: ``fsdp_size`` 0 takes
    ``procs // (dp·sp_ulysses·sp_ring)`` (JAX ``composition.py:238-240``);
    the sequence axes count only under ``attention_backend: "usp"``."""
    t = config.training
    usp = t.attention_backend == "usp"
    sp_u, sp_r = (t.sp_ulysses_size, t.sp_ring_size) if usp else (1, 1)
    fsdp = t.fsdp_size or max(procs // (t.dp_size * sp_u * sp_r), 1)
    return MeshConfig(dp=t.dp_size, fsdp=fsdp, sp_ulysses=sp_u, sp_ring=sp_r)


def _build_mesh(config: Config, device: torch.device):
    """The rank grid (None for one process without USP), after the checks
    of the JAX composition: a ``max_length`` that divides into the USP
    chunks, a global batch that divides into the ``dp·fsdp`` batch blocks,
    and one process per rank."""
    t = config.training
    procs = process_count()
    mesh_cfg = mesh_config(config, procs)
    sp = mesh_cfg.sp_ulysses * mesh_cfg.sp_ring
    if config.data.max_length % sp != 0:
        raise ValueError(
            f"data.max_length={config.data.max_length} must be divisible by "
            f"sp_ulysses*sp_ring={sp} for USP"
        )
    if sp > 1 and t.batch_size != mesh_cfg.batch_blocks:
        raise ValueError(
            f"USP takes one row per batch block: training.batch_size="
            f"{t.batch_size} must be dp*fsdp={mesh_cfg.batch_blocks}"
        )
    if t.batch_size % mesh_cfg.batch_blocks != 0:
        raise ValueError(
            f"training.batch_size={t.batch_size} (global) must be divisible "
            f"by dp*fsdp={mesh_cfg.batch_blocks} batch blocks"
        )
    if mesh_cfg.world_size != procs:
        raise ValueError(
            f"the mesh dp={mesh_cfg.dp} x fsdp={mesh_cfg.fsdp} x "
            f"sp_ulysses={mesh_cfg.sp_ulysses} x sp_ring={mesh_cfg.sp_ring} "
            f"needs one process per rank, {mesh_cfg.world_size}, have {procs} "
            "(start each with SPECFORGE_COORDINATOR, SPECFORGE_NUM_PROCESSES "
            "and SPECFORGE_PROCESS_ID)"
        )
    if procs == 1 and t.attention_backend != "usp":
        return None
    return build_mesh(mesh_cfg, device)


def build_training_run(config: Config, registry=None, frozen_override=None,
                       device: DeviceLike = None) -> Trainer:
    """Build a fully wired offline Trainer: CUDA unless the caller names
    another device (``device="cpu"`` in the tests); without a card and
    without a device named this raises. Under the multi-process env this
    process is one rank (its own card when there is one per rank)."""
    device = resolve_device(device)
    _refuse_unported(config)
    device = maybe_initialize_distributed(device)
    mesh = _build_mesh(config, device)
    resolved = resolve_run(config, registry)
    providers = resolved.registration.providers
    t = config.training
    options = _strategy_options(config)

    compute_dtype = (torch.float32 if config.model.compute_dtype == "float32"
                     else torch.bfloat16)
    draft, draft_config = providers.build_draft(
        resolved.draft_config_dict, dtype=compute_dtype,
        attention_backend=t.attention_backend, device=device, seed=t.seed,
        **({"mesh": mesh} if t.attention_backend == "usp" else {}),
    )
    if options.get("mask_token_id") is None:
        options["mask_token_id"] = getattr(draft_config, "mask_token_id", 0)
    model = providers.build_training_model(draft, options)
    # the ranks whose losses and metrics sum into the global batch's
    model.mesh = mesh
    strategy = providers.build_strategy(model, options)
    if config.model.draft_checkpoint_path:
        # before any optimizer state, and under fsdp before the trainer
        # slices the masters: every rank loads the same whole weights
        warm_start_draft(model, config.model.draft_checkpoint_path)
        logger.info("warm-started draft weights from %s",
                    config.model.draft_checkpoint_path)
    if config.data.eval_data_path and not hasattr(strategy, "eval_outputs"):
        raise NotImplementedError(
            f"an eval pass for {t.strategy!r}: the JAX strategies of the "
            "DFlash family (DSpark's too) and P-EAGLE define none, and the "
            "JAX evaluator calls one all the same (ROADMAP.md, Queue 3, "
            "specforge_tpu/eval/evaluator.py:50)"
        )
    if config.data.pack_documents and not getattr(
            strategy, "supports_packed_documents", False):
        raise ValueError(
            "data.pack_documents requires a strategy that consumes document "
            f"boundaries (P-EAGLE); {t.strategy!r} does not"
        )

    frozen = (
        {k: torch.as_tensor(v) for k, v in frozen_override.items()}
        if frozen_override is not None
        else _load_target_tables(config)
    )
    mapping = _resolve_vocab_mapping(config, draft_config)
    if mapping is not None:
        draft.set_vocab_maps(*mapping)
    trainable_mask = None
    if t.strategy in ("eagle3", "peagle"):
        # the draft embedding is target-copied; the table is then not
        # carried through every step. EAGLE3 freezes it (in bf16); P-EAGLE
        # trains it in fp32
        embed = frozen.pop("target_embed_weight", None)
        if embed is not None and embed.shape == draft.embed_tokens.weight.shape:
            with torch.no_grad():
                draft.embed_tokens.weight.copy_(embed)
    if t.strategy == "eagle3":
        trainable_mask = embedding_freeze_mask(model)
        cast_frozen_to(model, trainable_mask, torch.bfloat16)
    # loaded tables are bf16 already; an override keeps its dtype, as in
    # the JAX package
    frozen = {k: v.to(device) for k, v in frozen.items()}

    if not config.data.train_data_path:
        raise ValueError("data.train_data_path is required for offline runs")
    contract = resolved.registration.spec.contract_for(FeatureMode.OFFLINE)
    # features stay in their stored dtype (bf16 captures): the JAX package
    # casts them to fp32 here, which on a TPU costs little (an fp32 product
    # runs in bf16 passes there); on the card it doubles the host→device
    # bytes and turns the teacher's head product into an fp32 FFMA GEMM.
    # The values are the same: every consumer casts to its compute dtype,
    # and the teacher accumulates in fp32 either way.
    # this rank's rows of every global batch
    rows = t.batch_size // (mesh.config.batch_blocks if mesh else 1)
    per_row = config.data.docs_per_row if config.data.pack_documents else 1
    if config.data.pack_documents:
        collate = PackingCollator(PackingCollatorConfig(
            max_length=config.data.max_length, rows=rows,
            max_docs_per_row=config.data.docs_per_row))
    else:
        collate = PaddingCollator(
            CollatorConfig(max_length=config.data.max_length))
    loader_batch = rows * per_row
    metadata = {"target_repr": contract.target_representation}

    def make_loader(root):
        # every rank of a sequence group loads the same samples
        refs = shard_refs_for_process(OfflineManifestReader(root).read(),
                                      t.batch_size * per_row, grid=mesh)
        return FeatureDataLoader(
            FileFeatureStore(), collate, refs=refs,
            batch_size=loader_batch, num_workers=config.data.num_workers,
            prefetch_batches=config.data.prefetch_batches, metadata=metadata,
        )

    train_loader = make_loader(config.data.train_data_path)
    eval_loader = (make_loader(config.data.eval_data_path)
                   if config.data.eval_data_path else None)
    # the primary rank alone writes metrics and markers
    tracker = build_tracker(
        config.tracking.backend if is_primary() else "none",
        output_dir=config.output_dir,
        run_id=config.run_id, project=config.tracking.project,
    )
    trainer_config = TrainerConfig(
        num_epochs=t.num_epochs,
        accum_steps=t.accumulation_steps,
        grads_dtype=t.grads_dtype,
        compute_params_dtype=t.compute_params_dtype,
        log_interval=t.log_interval,
        eval_interval=t.eval_interval,
        checkpoint_interval=t.save_interval,
        max_checkpoints=t.max_checkpoints,
        output_dir=config.output_dir,
        run_id=config.run_id,
        resume=t.resume,
        resume_from=t.resume_from,
        total_steps=t.total_steps,
        profiling=ProfilingConfig(
            enabled=config.profiling.enabled,
            start_step=config.profiling.start_step,
            num_steps=config.profiling.num_steps,
            output_dir=os.path.join(config.output_dir, "profiles"),
        ),
    )
    optimizer_config = OptimizerConfig(
        lr=t.learning_rate,
        weight_decay=t.weight_decay,
        max_grad_norm=t.max_grad_norm,
        warmup_ratio=t.warmup_ratio,
        lr_scheduler=t.lr_scheduler,
        adam_b1=t.adam_b1,
        adam_b2=t.adam_b2,
        moments_dtype=t.moments_dtype,
        factored_second_moments=t.factored_second_moments,
        row_sparse_embedding=t.row_sparse_embedding,
    )
    fingerprints = {
        "draft_config_fingerprint": draft_config_fingerprint(
            resolved.draft_config_dict
        ),
        "model_fingerprints": {
            "target": frozen_input_fingerprint(config.model.target_model_path),
        },
    }
    return Trainer(
        strategy,
        train_loader=train_loader,
        eval_loader=eval_loader,
        config=trainer_config,
        optimizer_config=optimizer_config,
        frozen=frozen,
        tracker=tracker,
        trainable_mask=trainable_mask,
        metadata=metadata,
        contract_fingerprints=fingerprints,
        mesh=mesh,
    )
