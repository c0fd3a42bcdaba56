"""Built-in algorithm registrations of the port: eagle3, dflash, domino,
dspark, peagle.

Counterpart of ``specforge_tpu/algorithms/builtin.py``, for EAGLE3 (and
EAGLE3.1, which is eagle3 with ``fc_norm: true`` in the draft config), the
DFlash family's dflash, domino and dspark, and P-EAGLE: every algorithm of
the JAX package.
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
from specforge_tpu_torch.algorithms.providers import (
    AlgorithmProviders,
    dflash_capture_layers,
    eagle_capture_layers,
)
from specforge_tpu_torch.algorithms.registry import (
    AlgorithmRegistration,
    AlgorithmRegistry,
)

def _eagle3_build_draft(config_dict: Dict[str, Any], dtype=torch.bfloat16,
                        attention_backend: str = "dense", device=None,
                        seed: int = 0, mesh=None):
    from specforge_tpu_torch.models.draft.llama_eagle3 import (
        Eagle3Config,
        LlamaEagle3Draft,
    )

    config = Eagle3Config.from_dict(config_dict)
    draft = LlamaEagle3Draft(config, dtype=dtype,
                             attention_backend=attention_backend,
                             device=device, seed=seed, mesh=mesh)
    return draft, config


def _eagle3_config(config_dict: Dict[str, Any]):
    from specforge_tpu_torch.models.draft.llama_eagle3 import Eagle3Config

    return Eagle3Config.from_dict(config_dict)


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
        draft_config=_eagle3_config,
        resolve_capture_layers=eagle_capture_layers,
        frozen_requirements=frozenset({"target_head_weight"}),
    ),
)


# --- dflash family ---------------------------------------------------------

def _dflash_build_draft(draft_cls_name: str):
    def build(config_dict: Dict[str, Any], dtype=torch.bfloat16,
              attention_backend: str = "auto", device=None, seed: int = 0):
        """The family reads its attention backend from the draft config
        (``attention_backend``: "auto", "pallas" or "chunked"), not from
        ``training.attention_backend``, as the JAX package does."""
        from specforge_tpu_torch.models.draft import dflash, domino, dspark

        config = dflash.DFlashConfig.from_dict(config_dict)
        cls = {"DFlashDraftModel": dflash.DFlashDraftModel,
               "DominoDraftModel": domino.DominoDraftModel,
               "DSparkDraftModel": dspark.DSparkDraftModel}[draft_cls_name]
        draft = cls(
            config, dtype=dtype,
            attention_backend=config_dict.get("attention_backend", "auto"),
            attn_chunk_blocks=int(config_dict.get("attn_chunk_blocks", 8)),
            device=device, seed=seed,
        )
        return draft, config

    return build


def _dflash_config(config_dict: Dict[str, Any]):
    from specforge_tpu_torch.models.draft.dflash import DFlashConfig

    return DFlashConfig.from_dict(config_dict)


def _dflash_family_training_model(wrapper_name: str):
    def build(draft, options: Dict[str, Any]):
        from specforge_tpu_torch.algorithms.common import dflash_family

        kwargs = dict(
            draft_model=draft,
            mask_token_id=int(options.get(
                "mask_token_id", draft.config.mask_token_id or 0)),
            block_size=int(options.get("block_size", draft.config.block_size)),
            num_anchors=int(options.get("num_anchors", 512)),
            loss_decay_gamma=options.get("loss_decay_gamma"),
            objective_chunk_blocks=int(
                options.get("objective_chunk_blocks", 128)),
            fused_objective=bool(options.get("fused_vocab_objective", True)),
        )
        if wrapper_name == "OnlineDFlashModel":
            kwargs["loss_type"] = options.get("loss_type", "dflash")
            kwargs["dpace_alpha"] = float(options.get("dpace_alpha", 0.5))
        elif wrapper_name == "OnlineDominoModel":
            kwargs["shift_label"] = bool(
                options.get("shift_label", draft.config.shift_label))
        else:
            for key, default in (("dspark_ce_loss_alpha", 0.1),
                                 ("dspark_l1_loss_alpha", 0.9),
                                 ("dspark_confidence_head_alpha", 1.0)):
                kwargs[key] = float(options.get(key, default))
        return getattr(dflash_family, wrapper_name)(**kwargs)

    return build


def _dflash_family_strategy(strategy_name: str):
    def build(model, options: Dict[str, Any]):
        from specforge_tpu_torch.training import strategies

        kwargs = {"seed": int(options.get("seed", 0))}
        if strategy_name == "DominoTrainStrategy":
            kwargs["lambda_start"] = float(options.get("lambda_start", 1.0))
            kwargs["decay_ratio"] = float(options.get("decay_ratio", 0.5))
        return getattr(strategies, strategy_name)(model, **kwargs)

    return build


def _dflash_registration(name: str, draft_arch: str, wrapper_name: str,
                         strategy_name: str, last_hidden_feature=None
                         ) -> AlgorithmRegistration:
    """The family's registration; DSpark also reads the target's last
    hidden state (``last_hidden_feature``)."""
    features = frozenset({"input_ids", "loss_mask", "hidden_states",
                          *([last_hidden_feature] if last_hidden_feature
                            else [])})
    return AlgorithmRegistration(
        spec=AlgorithmSpec(
            name=name,
            draft=DraftRequirement(
                compatible_architectures=frozenset({draft_arch}),
                default_architecture=draft_arch,
            ),
            feature_contracts=tuple(
                FeatureContract(mode=mode, required_features=features,
                                target_representation="hidden_state")
                for mode in (FeatureMode.OFFLINE, FeatureMode.STREAMING)
            ),
            offline_schema=OfflineStorageSchema(
                format="specforge_dflash_states_v1",
                feature_names=tuple(sorted(features)),
                aux_feature="hidden_states",
                last_hidden_feature=last_hidden_feature,
            ),
            capabilities=AlgorithmCapabilities(),
        ),
        providers=AlgorithmProviders(
            build_draft=_dflash_build_draft(draft_arch),
            build_training_model=_dflash_family_training_model(wrapper_name),
            build_strategy=_dflash_family_strategy(strategy_name),
            draft_config=_dflash_config,
            resolve_capture_layers=dflash_capture_layers,
            frozen_requirements=frozenset(
                {"target_head_weight", "target_embed_weight"}),
        ),
    )


DFLASH = _dflash_registration("dflash", "DFlashDraftModel",
                              "OnlineDFlashModel", "DFlashTrainStrategy")
DOMINO = _dflash_registration("domino", "DominoDraftModel",
                              "OnlineDominoModel", "DominoTrainStrategy")
DSPARK = _dflash_registration("dspark", "DSparkDraftModel",
                              "OnlineDSparkModel", "DSparkTrainStrategy",
                              last_hidden_feature="target_last_hidden_states")


# --- peagle ----------------------------------------------------------------

def _peagle_build_draft(config_dict: Dict[str, Any], dtype=torch.bfloat16,
                        attention_backend: str = "auto", device=None,
                        seed: int = 0):
    """P-EAGLE reads its attention backend from the draft config ("auto" or
    "pallas": the COD kernels; "dense": the masked [B, T, T] path), as the
    JAX package does."""
    from specforge_tpu_torch.models.draft.peagle import (
        PEagleConfig,
        PEagleDraftModel,
    )

    config = PEagleConfig.from_dict(config_dict)
    draft = PEagleDraftModel(
        config, dtype=dtype,
        attention_backend=config_dict.get("attention_backend", "auto"),
        device=device, seed=seed,
    )
    return draft, config


def _peagle_config(config_dict: Dict[str, Any]):
    from specforge_tpu_torch.models.draft.peagle import PEagleConfig

    return PEagleConfig.from_dict(config_dict)


def _peagle_build_training_model(draft, options: Dict[str, Any]):
    from specforge_tpu_torch.algorithms.peagle.model import OnlinePEagleModel

    return OnlinePEagleModel(
        draft,
        mask_token_id=int(options.get("mask_token_id") or 0),
        num_depths=int(options.get("num_depths", 8)),
        down_sample_ratio=float(options.get("down_sample_ratio", 0.7)),
        down_sample_ratio_min=float(options.get("down_sample_ratio_min", 0.2)),
    )


def _peagle_build_strategy(model, options: Dict[str, Any]):
    from specforge_tpu_torch.training.strategies import PEagleTrainStrategy

    return PEagleTrainStrategy(model, seed=int(options.get("seed", 0)))


PEAGLE = AlgorithmRegistration(
    spec=AlgorithmSpec(
        name="peagle",
        draft=DraftRequirement(
            compatible_architectures=frozenset({"PEagleDraftModel"}),
            default_architecture="PEagleDraftModel",
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
            supports_vocab_mapping=True, max_batch_size=1
        ),
    ),
    providers=AlgorithmProviders(
        build_draft=_peagle_build_draft,
        build_training_model=_peagle_build_training_model,
        build_strategy=_peagle_build_strategy,
        draft_config=_peagle_config,
        resolve_capture_layers=eagle_capture_layers,
        frozen_requirements=frozenset({"target_head_weight"}),
    ),
)


def builtin_algorithm_registry() -> AlgorithmRegistry:
    return AlgorithmRegistry([EAGLE3, DFLASH, DOMINO, DSPARK, PEAGLE])
