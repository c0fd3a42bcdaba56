"""Composition root: Config → runnable training run, on one device.

Counterpart of ``specforge_tpu/application/composition.py`` for EAGLE3
offline: resolves the algorithm registration, builds the draft, training
model and strategy through the providers, loads the frozen target tables and
the vocab mapping (from a file, or derived from the training features),
copies and freezes the target embedding (the frozen table cast to bf16),
wires the ``PaddingCollator`` loaders and the tracker, and returns the
:class:`Trainer`. What the port has not reached yet (a mesh, USP, document
packing, online runs, other algorithms, a warm start) is refused with the
slice that brings it.
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
from specforge_tpu_torch.data.collator import CollatorConfig, PaddingCollator
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
    if t.attention_backend == "usp":
        raise NotImplementedError(
            "attention_backend='usp' comes with the sequence-parallel slice "
            "(ROADMAP.md, Queue 1 item 6)"
        )
    if t.dp_size > 1 or t.fsdp_size > 1:
        raise NotImplementedError(
            f"a training mesh (dp_size={t.dp_size}, fsdp_size={t.fsdp_size}) "
            "comes with the parallelism slice (ROADMAP.md, Queue 1 item 6)"
        )
    if config.data.pack_documents:
        raise NotImplementedError(
            "data.pack_documents comes with the P-EAGLE slice (ROADMAP.md, "
            "Queue 1 item 5)"
        )
    if config.model.draft_checkpoint_path:
        raise NotImplementedError(
            "model.draft_checkpoint_path (warm_start_draft) is not ported "
            "yet; see ROADMAP.md, Queue 1"
        )


def _strategy_options(config: Config) -> Dict[str, Any]:
    t = config.training
    return {
        "ttt_length": t.ttt_length,
        "ploss_decay": t.ploss_decay,
        "lk_loss_type": t.lk_loss_type,
        "kl_scale": t.kl_scale,
        "kl_decay": t.kl_decay,
        "compact_teacher": t.compact_teacher,
        "compact_teacher_chunk_size": t.compact_teacher_chunk_size,
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
    draft_vocab = draft_config.draft_vocab_size
    vocab = draft_config.vocab_size
    if not draft_vocab or draft_vocab >= (vocab or 0):
        return None
    if config.model.vocab_mapping_path:
        return load_vocab_mapping(config.model.vocab_mapping_path)
    if config.data.train_data_path:
        cache = os.path.join(
            config.output_dir, f"{config.run_id}.vocab_mapping.npz"
        )
        if os.path.exists(cache):
            return load_vocab_mapping(cache)
        logger.info("deriving vocab mapping from %s",
                    config.data.train_data_path)
        t2d, d2t = derive_from_offline_dir(
            config.data.train_data_path, vocab, draft_vocab
        )
        save_vocab_mapping(cache, t2d, d2t)
        return t2d, d2t
    return None


def build_training_run(config: Config, registry=None, frozen_override=None,
                       device: DeviceLike = None) -> Trainer:
    """Build a fully wired offline Trainer on one device: CUDA unless the
    caller names another (``device="cpu"`` in the tests); without a card
    and without a device named this raises."""
    device = resolve_device(device)
    _refuse_unported(config)
    resolved = resolve_run(config, registry)
    providers = resolved.registration.providers
    t = config.training
    options = _strategy_options(config)

    compute_dtype = (torch.float32 if config.model.compute_dtype == "float32"
                     else torch.bfloat16)
    draft, draft_config = providers.build_draft(
        resolved.draft_config_dict, dtype=compute_dtype,
        attention_backend=t.attention_backend, device=device, seed=t.seed,
    )
    model = providers.build_training_model(draft, options)
    strategy = providers.build_strategy(model, options)

    frozen = (
        {k: torch.as_tensor(v) for k, v in frozen_override.items()}
        if frozen_override is not None
        else _load_target_tables(config)
    )
    mapping = _resolve_vocab_mapping(config, draft_config)
    if mapping is not None:
        draft.set_vocab_maps(*mapping)
    embed = frozen.pop("target_embed_weight", None)
    if embed is not None and embed.shape == draft.embed_tokens.weight.shape:
        # the EAGLE3 contract: the draft embedding is target-copied, frozen
        with torch.no_grad():
            draft.embed_tokens.weight.copy_(embed)
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
    collate = PaddingCollator(CollatorConfig(max_length=config.data.max_length))
    metadata = {"target_repr": contract.target_representation}

    def make_loader(root):
        return FeatureDataLoader(
            FileFeatureStore(), collate,
            refs=OfflineManifestReader(root).read(),
            batch_size=t.batch_size, num_workers=config.data.num_workers,
            prefetch_batches=config.data.prefetch_batches, metadata=metadata,
        )

    train_loader = make_loader(config.data.train_data_path)
    eval_loader = (make_loader(config.data.eval_data_path)
                   if config.data.eval_data_path else None)
    tracker = build_tracker(
        config.tracking.backend, output_dir=config.output_dir,
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
    )
