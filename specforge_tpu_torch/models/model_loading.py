"""Exported draft weights → the port's parameter names.

Counterpart of ``specforge_tpu/models/model_loading.py``. An exported draft
(``model.safetensors`` in the HF or SGLang layout) carries torch-convention
keys: ``layers.N``, ``fc_norm.N``, Domino's ``embed_proj.{0,2}`` (a
``Sequential(Linear, SiLU, Linear)``), the GRU's ``weight_ih_l0`` and the
split ``q_proj``/``k_proj``/``v_proj`` and ``gate_proj``/``up_proj`` of the
merged projections. The port's names are the JAX package's module names
(``layers_N``, ``embed_proj_1``, merged ``qkv_proj``/``gate_up_proj``) over
torch's [out, in] layout, so the mapping only renames and concatenates:
no weight transposes (``convert.params_from_jax`` keeps the same
conventions). ``t2d``/``d2t`` fill the vocab-mapping buffers.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

#: torch dotted segment pairs → the port's module names
_PAIR_MAP = {
    ("embed_proj", "0"): "embed_proj_0",
    ("embed_proj", "2"): "embed_proj_1",
}
_SEG_MAP = {"weight_ih_l0": "weight_ih", "weight_hh_l0": "weight_hh"}
#: merged projections and the exported pieces they concatenate, in order
_MERGED_PARTS = {
    "qkv_proj": ("q_proj", "k_proj", "v_proj"),
    "gate_up_proj": ("gate_proj", "up_proj"),
}
_BUFFER_DTYPES = {"t2d": torch.bool, "d2t": torch.int64}


def port_name(torch_name: str) -> str:
    """An exported tensor name → the port's parameter name."""
    parts = torch_name.split(".")
    out: List[str] = []
    i = 0
    while i < len(parts):
        if i + 1 < len(parts):
            pair = (parts[i], parts[i + 1])
            if pair in _PAIR_MAP:
                out.append(_PAIR_MAP[pair])
                i += 2
                continue
            if parts[i] in ("layers", "fc_norm") and parts[i + 1].isdigit():
                out.append(f"{parts[i]}_{parts[i + 1]}")
                i += 2
                continue
        out.append(_SEG_MAP.get(parts[i], parts[i]))
        i += 1
    return ".".join(out)


def _checked(name: str, value: torch.Tensor, expected: torch.Tensor
             ) -> torch.Tensor:
    if tuple(value.shape) != tuple(expected.shape):
        raise ValueError(
            f"warm start shape mismatch at {name}: {tuple(value.shape)} vs "
            f"{tuple(expected.shape)}"
        )
    return value.float().to(expected.dtype)


def draft_state_from_export(
    tensors: Mapping[str, torch.Tensor],
    expected: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """The port tensors an export provides: for every name of ``expected``
    (the draft's parameters and buffers, by port name) that the export
    holds, directly or as the pieces of a merged projection, the value in
    the expected dtype. Export names the draft lacks are ignored; a shape
    mismatch raises."""
    out: Dict[str, torch.Tensor] = {}
    normalized: Dict[str, torch.Tensor] = {}
    for name, value in tensors.items():
        if name in _BUFFER_DTYPES:
            if name in expected:
                out[name] = value.to(_BUFFER_DTYPES[name])
            continue
        key = port_name(name)
        normalized[key] = value
        if key in expected:
            out[key] = _checked(key, value, expected[key])
    for key, want in expected.items():
        stem, _, leaf = key.rpartition(".")
        base, _, merged = stem.rpartition(".")
        if merged not in _MERGED_PARTS:
            continue
        prefix = f"{base}." if base else ""
        pieces = [normalized.get(f"{prefix}{part}.{leaf}")
                  for part in _MERGED_PARTS[merged]]
        if any(p is None for p in pieces):
            continue
        out[key] = _checked(key, torch.cat([p.float() for p in pieces]), want)
    return out
