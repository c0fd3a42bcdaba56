"""Executable provider ports per algorithm.

Counterpart of ``specforge_tpu/algorithms/providers.py``: the factories
behind the pure contracts (draft construction, training-model wrapping,
strategy construction). The JAX package's ``init_variables`` has no
counterpart: a torch module initialises its own weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, FrozenSet, Tuple

#: (config dict, dtype, attention_backend, device, seed) → (module, config)
BuildDraft = Callable[..., Tuple[Any, Any]]
BuildTrainingModel = Callable[..., Any]                # (draft, options) -> module
BuildStrategy = Callable[..., Any]                     # (model, options) -> strategy


@dataclass(frozen=True)
class AlgorithmProviders:
    build_draft: BuildDraft
    build_training_model: BuildTrainingModel
    build_strategy: BuildStrategy
    # frozen tensors the strategy reads from the `frozen` dict each step
    frozen_requirements: FrozenSet[str] = frozenset()
