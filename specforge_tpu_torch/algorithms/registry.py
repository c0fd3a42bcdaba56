"""Algorithm registry: immutable catalog of (spec, providers) pairs.

Counterpart of ``specforge_tpu/algorithms/registry.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from specforge_tpu_torch.algorithms.contracts import AlgorithmSpec


@dataclass(frozen=True)
class AlgorithmRegistration:
    spec: AlgorithmSpec
    providers: "AlgorithmProviders"

    @property
    def name(self) -> str:
        return self.spec.name


class AlgorithmRegistry:
    def __init__(self, registrations) -> None:
        by_name: Dict[str, AlgorithmRegistration] = {}
        for reg in registrations:
            if reg.name in by_name:
                raise ValueError(f"duplicate algorithm {reg.name!r}")
            by_name[reg.name] = reg
        self._by_name = by_name

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._by_name))

    def resolve(self, name: str) -> AlgorithmRegistration:
        if name not in self._by_name:
            raise KeyError(
                f"unknown algorithm {name!r}; available: {list(self.names)}"
            )
        return self._by_name[name]
