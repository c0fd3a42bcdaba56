"""Capture contract: what the target side must deliver for each sample.

Counterpart of ``specforge_tpu/inference/capture.py``: a typed description
of the expected capture, checked *before* any store write, so a
misconfigured server never poisons the feature stream. Tensors may be
``torch`` tensors or numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Tuple


@dataclass(frozen=True)
class CaptureConfig:
    hidden_size: int
    num_capture_layers: int
    target_repr: str = "hidden_state"  # hidden_state | logits
    vocab_size: Optional[int] = None
    dtype: str = "bfloat16"
    aux_feature: str = "hidden_state"
    last_hidden_feature: str = "target"
    extra_features: Tuple[str, ...] = ("input_ids", "loss_mask")


class CaptureVerificationError(ValueError):
    pass


def verify_capture(tensors: Mapping[str, object],
                   config: CaptureConfig) -> None:
    """Validate one captured sample's tensors against the contract."""
    for name in (config.aux_feature, *config.extra_features):
        if name not in tensors:
            raise CaptureVerificationError(
                f"capture missing feature {name!r}; present={sorted(tensors)}"
            )
    seq_len = tuple(tensors["input_ids"].shape)[0]
    aux_shape = tuple(tensors[config.aux_feature].shape)
    expected_aux = config.num_capture_layers * config.hidden_size
    if len(aux_shape) != 2 or aux_shape != (seq_len, expected_aux):
        raise CaptureVerificationError(
            f"{config.aux_feature} must be [seq={seq_len}, "
            f"{config.num_capture_layers}*{config.hidden_size}], got "
            f"{aux_shape}"
        )
    last = tensors.get(config.last_hidden_feature)
    if last is not None:
        if config.target_repr == "hidden_state":
            expected = (seq_len, config.hidden_size)
        else:
            if config.vocab_size is None:
                raise CaptureVerificationError(
                    "logits capture requires vocab_size in CaptureConfig")
            expected = (seq_len, config.vocab_size)
        if tuple(last.shape) != expected:
            raise CaptureVerificationError(
                f"{config.last_hidden_feature} must be {expected}, got "
                f"{tuple(last.shape)}"
            )
