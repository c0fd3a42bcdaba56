"""Pure contracts describing what a draft-training algorithm consumes.

The port's own copy of ``specforge_tpu/algorithms/contracts.py``. Value-only
(no factories, no classes with behavior): the registry pairs each
:class:`AlgorithmSpec` with executable providers; this module stays
importable anywhere without pulling model code, and checks recursively that
a spec holds no executables.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, fields, is_dataclass
from enum import Enum
from typing import Dict, FrozenSet, Mapping, Optional, Tuple

_ALGORITHM_NAME = re.compile(r"^[a-z][a-z0-9_.-]*$")


def assert_pure_value(value: object, path: str = "value") -> None:
    """Reject executables/opaque state recursively from public contracts."""
    if isinstance(value, type) or callable(value):
        raise TypeError(f"{path} must be a pure value, got executable {value!r}")
    if value is None or isinstance(value, (str, int, float, bool, Enum)):
        return
    if isinstance(value, (tuple, list, set, frozenset)):
        for i, item in enumerate(value):
            assert_pure_value(item, f"{path}[{i}]")
        return
    if isinstance(value, Mapping):
        for k, v in value.items():
            assert_pure_value(k, f"{path}.key")
            assert_pure_value(v, f"{path}[{k!r}]")
        return
    if is_dataclass(value) and not isinstance(value, type):
        for f in fields(value):
            assert_pure_value(getattr(value, f.name), f"{path}.{f.name}")
        return
    raise TypeError(
        f"{path} must contain only serializable values, got "
        f"{type(value).__name__}"
    )


class FeatureMode(str, Enum):
    OFFLINE = "offline"
    STREAMING = "streaming"


@dataclass(frozen=True)
class DraftRequirement:
    """Which draft architectures an algorithm accepts."""

    compatible_architectures: FrozenSet[str]
    default_architecture: str

    def __post_init__(self) -> None:
        if self.default_architecture not in self.compatible_architectures:
            raise ValueError(
                "default_architecture must be in compatible_architectures"
            )


@dataclass(frozen=True)
class FeatureContract:
    """Feature-tensor names an algorithm consumes per mode."""

    mode: FeatureMode
    required_features: FrozenSet[str]
    target_representation: str = "hidden_state"  # hidden_state | logits

    def __post_init__(self) -> None:
        if not self.required_features:
            raise ValueError("required_features must not be empty")


@dataclass(frozen=True)
class OfflineStorageSchema:
    """What an offline capture file stores for this algorithm."""

    format: str
    feature_names: Tuple[str, ...]
    aux_feature: Optional[str] = None
    last_hidden_feature: Optional[str] = None


@dataclass(frozen=True)
class AlgorithmCapabilities:
    supports_compact_teacher: bool = False
    supports_vocab_mapping: bool = False
    max_batch_size: Optional[int] = None
    supports_sequence_parallel: bool = False


@dataclass(frozen=True)
class AlgorithmSpec:
    name: str
    draft: DraftRequirement
    feature_contracts: Tuple[FeatureContract, ...]
    offline_schema: Optional[OfflineStorageSchema] = None
    capabilities: AlgorithmCapabilities = field(
        default_factory=AlgorithmCapabilities
    )

    def __post_init__(self) -> None:
        if not _ALGORITHM_NAME.match(self.name):
            raise ValueError(f"invalid algorithm name {self.name!r}")
        assert_pure_value(self, f"AlgorithmSpec({self.name})")

    def contract_for(self, mode: FeatureMode) -> FeatureContract:
        for contract in self.feature_contracts:
            if contract.mode == mode:
                return contract
        raise KeyError(
            f"algorithm {self.name!r} has no feature contract for mode "
            f"{mode.value!r}"
        )
