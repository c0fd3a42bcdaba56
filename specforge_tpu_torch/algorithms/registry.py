"""Algorithm registry: immutable catalog of (spec, providers) pairs.

Counterpart of ``specforge_tpu/algorithms/registry.py``. Algorithms of the
JAX package that the port has not reached yet are known by name and refused
with the slice that brings them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

from specforge_tpu_torch.algorithms.contracts import AlgorithmSpec


@dataclass(frozen=True)
class AlgorithmRegistration:
    spec: AlgorithmSpec
    providers: "AlgorithmProviders"

    @property
    def name(self) -> str:
        return self.spec.name


class AlgorithmRegistry:
    def __init__(self, registrations,
                 queued: Optional[Mapping[str, str]] = None) -> None:
        by_name: Dict[str, AlgorithmRegistration] = {}
        for reg in registrations:
            if reg.name in by_name:
                raise ValueError(f"duplicate algorithm {reg.name!r}")
            by_name[reg.name] = reg
        self._by_name = by_name
        #: name → the slice of the port that brings it
        self._queued = dict(queued or {})

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._by_name))

    def resolve(self, name: str) -> AlgorithmRegistration:
        if name in self._queued:
            raise NotImplementedError(
                f"algorithm {name!r} is not ported yet; it comes with "
                f"{self._queued[name]}"
            )
        if name not in self._by_name:
            raise KeyError(
                f"unknown algorithm {name!r}; available: {list(self.names)}"
            )
        return self._by_name[name]
