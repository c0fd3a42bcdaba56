"""Executable provider ports per algorithm.

Counterpart of ``specforge_tpu/algorithms/providers.py``: the factories
behind the pure contracts (draft construction, training-model wrapping,
strategy construction, capture-layer resolution). The JAX package's
``init_variables`` has no counterpart: a torch module initialises its own
weights. ``draft_config`` parses a draft config dict without building the
module (the JAX ``build_draft`` allocates nothing; the port's allocates
the weights), for the capture entry point's layer rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, Optional, Tuple

#: (config dict, dtype, attention_backend, device, seed) → (module, config)
BuildDraft = Callable[..., Tuple[Any, Any]]
BuildTrainingModel = Callable[..., Any]                # (draft, options) -> module
BuildStrategy = Callable[..., Any]                     # (model, options) -> strategy
ResolveCaptureLayers = Callable[..., Tuple[int, ...]]  # (draft_config, target_num_layers) -> layer ids


@dataclass(frozen=True)
class AlgorithmProviders:
    build_draft: BuildDraft
    build_training_model: BuildTrainingModel
    build_strategy: BuildStrategy
    draft_config: Callable[[Dict[str, Any]], Any]
    resolve_capture_layers: ResolveCaptureLayers
    # frozen tensors the strategy reads from the `frozen` dict each step
    frozen_requirements: FrozenSet[str] = frozenset()


def eagle_capture_layers(
    draft_config: Any, target_num_layers: int,
    override: Optional[Tuple[int, ...]] = None,
) -> Tuple[int, ...]:
    """EAGLE family: the run's override, else the draft config's
    ``eagle_config.eagle_aux_hidden_state_layer_ids``, else
    ``(1, n//2 - 1, n - 4)`` for a target of n layers."""
    if override is not None:
        layers = tuple(override)
    else:
        eagle_cfg = getattr(draft_config, "eagle_config", None) or {}
        layers = tuple(
            eagle_cfg.get("eagle_aux_hidden_state_layer_ids") or ()
        )
        if not layers:
            n = int(target_num_layers)
            layers = (1, n // 2 - 1, n - 4)
    if len(layers) != 3 or any(l < 0 for l in layers):
        raise ValueError(
            f"EAGLE capture layers must be 3 non-negative ints, got {layers!r}"
        )
    return layers


def dflash_capture_layers(
    draft_config: Any, target_num_layers: int,
    override: Optional[Tuple[int, ...]] = None,
) -> Tuple[int, ...]:
    """The target layers a DFlash-family draft reads: the run's override,
    else the draft config's (explicit or evenly spaced) target layer ids."""
    if override is not None:
        return tuple(override)
    return tuple(draft_config.resolved_target_layer_ids)
