"""Metadata contracts of the data plane (the port's own copy).

Counterpart of ``specforge_tpu/runtime/contracts.py``: dependency-light
dataclasses (stdlib only) whose records are metadata only, never tensors.
Tensors surface only inside :class:`TrainBatch`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple


class ContractViolation(TypeError):
    """Raised when a tensor-like object leaks into a metadata-only record."""


#: bytes per element of every dtype the data plane (de)serializes
DTYPE_SIZES = {
    "float64": 8, "int64": 8,
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1,
}
SUPPORTED_DTYPES = tuple(DTYPE_SIZES)


@dataclass(frozen=True)
class FeatureSpec:
    """Shape/dtype contract of one named feature tensor of one sample."""

    name: str
    shape: Tuple[int, ...]
    dtype: str

    def __post_init__(self) -> None:
        if self.dtype not in SUPPORTED_DTYPES:
            raise ValueError(
                f"FeatureSpec dtype {self.dtype!r} not in {SUPPORTED_DTYPES}"
            )
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def nbytes(self) -> int:
        n = DTYPE_SIZES[self.dtype]
        for s in self.shape:
            n *= s
        return n

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "shape": list(self.shape), "dtype": self.dtype}

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "FeatureSpec":
        return cls(name=obj["name"], shape=tuple(obj["shape"]),
                   dtype=str(obj["dtype"]))


@dataclass(frozen=True)
class FeatureHandle:
    """A pointer to one feature tensor inside a feature store, e.g.
    ``file:///data/sample-3.sft#hidden_state``."""

    uri: str
    spec: FeatureSpec

    def to_json(self) -> Dict[str, Any]:
        return {"uri": self.uri, "spec": self.spec.to_json()}

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "FeatureHandle":
        return cls(uri=obj["uri"], spec=FeatureSpec.from_json(obj["spec"]))


@dataclass(frozen=True)
class SampleRef:
    """Metadata-only record of one training sample's feature tensors."""

    sample_id: str
    features: Mapping[str, FeatureHandle]
    prompt_id: Optional[str] = None
    epoch: int = 0
    metadata: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        assert_no_tensors(self.metadata,
                          where=f"SampleRef({self.sample_id}).metadata")

    @property
    def nbytes(self) -> int:
        return sum(h.spec.nbytes for h in self.features.values())

    def to_json(self) -> Dict[str, Any]:
        return {
            "sample_id": self.sample_id,
            "prompt_id": self.prompt_id,
            "epoch": self.epoch,
            "features": {k: h.to_json() for k, h in self.features.items()},
            "metadata": dict(self.metadata),
        }

    @classmethod
    def from_json(cls, obj: Mapping[str, Any]) -> "SampleRef":
        return cls(
            sample_id=obj["sample_id"],
            prompt_id=obj.get("prompt_id"),
            epoch=int(obj.get("epoch", 0)),
            features={
                k: FeatureHandle.from_json(v) for k, v in obj["features"].items()
            },
            metadata=dict(obj.get("metadata", {})),
        )


@dataclass
class TrainBatch:
    """The only contract object allowed to carry tensors."""

    tensors: Dict[str, Any]
    sample_ids: List[str] = field(default_factory=list)
    metadata: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        assert_no_tensors(self.metadata, where="TrainBatch.metadata")


def _is_tensor_like(obj: Any) -> bool:
    # duck-typed so this module imports no array library: every array type
    # exposes .shape and .dtype; dataclasses (FeatureSpec) are recursed
    if isinstance(obj, (str, bytes, type)) or dataclasses.is_dataclass(obj):
        return False
    return hasattr(obj, "shape") and hasattr(obj, "dtype")


def assert_no_tensors(obj: Any, where: str = "value") -> None:
    """Recursively reject array-like objects in metadata-only records."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            assert_no_tensors(getattr(obj, f.name), where=f"{where}.{f.name}")
        return
    if _is_tensor_like(obj):
        raise ContractViolation(
            f"{where}: tensor-like object {type(obj).__name__} in metadata-only "
            "record; tensors must travel through the feature store"
        )
    if isinstance(obj, Mapping):
        for k, v in obj.items():
            assert_no_tensors(k, where=f"{where}.key")
            assert_no_tensors(v, where=f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for i, v in enumerate(obj):
            assert_no_tensors(v, where=f"{where}[{i}]")
