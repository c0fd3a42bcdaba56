"""Built-in algorithm registrations of the port: eagle3.

Counterpart of ``specforge_tpu/algorithms/builtin.py``, for EAGLE3 (and
EAGLE3.1, which is eagle3 with ``fc_norm: true`` in the draft config). The
JAX package's other algorithms are known by name and refused with the slice
of the port that brings them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from specforge_tpu_torch.algorithms.contracts import (
    AlgorithmCapabilities,
    AlgorithmSpec,
    DraftRequirement,
    FeatureContract,
    FeatureMode,
    OfflineStorageSchema,
)
from specforge_tpu_torch.algorithms.providers import AlgorithmProviders
from specforge_tpu_torch.algorithms.registry import (
    AlgorithmRegistration,
    AlgorithmRegistry,
)

#: algorithms of the JAX package not ported yet → the slice that brings them
QUEUED = {
    "dflash": "slice 3, the DFlash family (ROADMAP.md, Queue 1 item 4)",
    "domino": "slice 3, the DFlash family (ROADMAP.md, Queue 1 item 4)",
    "dspark": "slice 3, the DFlash family (ROADMAP.md, Queue 1 item 4)",
    "peagle": "slice 4, P-EAGLE (ROADMAP.md, Queue 1 item 5)",
}


def _eagle3_build_draft(config_dict: Dict[str, Any], dtype=torch.bfloat16,
                        attention_backend: str = "dense", device=None,
                        seed: int = 0):
    from specforge_tpu_torch.models.draft.llama_eagle3 import (
        Eagle3Config,
        LlamaEagle3Draft,
    )

    config = Eagle3Config.from_dict(config_dict)
    draft = LlamaEagle3Draft(config, dtype=dtype,
                             attention_backend=attention_backend,
                             device=device, seed=seed)
    return draft, config


def _eagle3_build_training_model(draft, options: Dict[str, Any]):
    from specforge_tpu_torch.algorithms.eagle3.model import OnlineEagle3Model

    return OnlineEagle3Model(
        draft_model=draft,
        length=int(options.get("ttt_length", 7)),
        lk_loss_type=options.get("lk_loss_type"),
        kl_scale=float(options.get("kl_scale", 1.0)),
        kl_decay=float(options.get("kl_decay", 1.0)),
        loss_backend=options.get("loss_backend", "fused"),
    )


def _eagle3_build_strategy(model, options: Dict[str, Any]):
    from specforge_tpu_torch.training.strategies import Eagle3TrainStrategy

    return Eagle3TrainStrategy(
        model,
        ploss_decay=float(options.get("ploss_decay", 0.8)),
        compact_teacher=bool(options.get("compact_teacher", False)),
        compact_teacher_chunk_size=int(
            options.get("compact_teacher_chunk_size", 32768)
        ),
    )


EAGLE3 = AlgorithmRegistration(
    spec=AlgorithmSpec(
        name="eagle3",
        draft=DraftRequirement(
            compatible_architectures=frozenset({"LlamaForCausalLMEagle3",
                                                "LlamaEagle3Draft"}),
            default_architecture="LlamaEagle3Draft",
        ),
        feature_contracts=(
            FeatureContract(
                mode=FeatureMode.OFFLINE,
                required_features=frozenset(
                    {"input_ids", "loss_mask", "hidden_state", "target"}
                ),
                target_representation="hidden_state",
            ),
            FeatureContract(
                mode=FeatureMode.STREAMING,
                required_features=frozenset(
                    {"input_ids", "loss_mask", "hidden_state", "target"}
                ),
                target_representation="logits",
            ),
        ),
        offline_schema=OfflineStorageSchema(
            format="specforge_hidden_states_v1",
            feature_names=("input_ids", "loss_mask", "hidden_state", "target"),
            aux_feature="hidden_state",
            last_hidden_feature="target",
        ),
        capabilities=AlgorithmCapabilities(
            supports_compact_teacher=True,
            supports_vocab_mapping=True,
            supports_sequence_parallel=True,
        ),
    ),
    providers=AlgorithmProviders(
        build_draft=_eagle3_build_draft,
        build_training_model=_eagle3_build_training_model,
        build_strategy=_eagle3_build_strategy,
        frozen_requirements=frozenset({"target_head_weight"}),
    ),
)


def builtin_algorithm_registry() -> AlgorithmRegistry:
    return AlgorithmRegistry([EAGLE3], queued=QUEUED)
