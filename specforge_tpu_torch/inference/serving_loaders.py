"""Serving loaders: a target and an exported draft, loaded for the decoder.

Counterpart of ``specforge_tpu/inference/serving_loaders.py`` for the
EAGLE3 family: the target read from its HF safetensors (no conversion), an
exported draft (HF or SGLang layout) read by the port's own safetensors
reader and mapped by ``models/model_loading.draft_state_from_export``, its
floating weights stored in bf16 as JAX stores them, and the chain decoder
built over both. Used by the HTTP endpoint (``serving_server_main.py``).

The DFlash-family and P-EAGLE exports are refused by name: their decoders
and loaders come with ``ROADMAP.md`` Queue 1 item 8.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from specforge_tpu_torch.inference.spec_decode import (
    SERVING_LATER,
    Eagle3SpecDecoder,
)
from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    LlamaEagle3Draft,
)
from specforge_tpu_torch.models.model_loading import draft_state_from_export
from specforge_tpu_torch.models.target.transformer import (
    TargetConfig,
    load_target_params,
)
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    load_feature_file,
)
from specforge_tpu_torch.utils import DeviceLike, resolve_device


def export_family(config: dict) -> str:
    """The draft family an exported ``config.json`` describes: ``dflash``
    (DFlash, Domino, DSpark: a ``dflash_config`` or a ``block_size``),
    ``peagle`` or ``eagle3``."""
    if "dflash_config" in config or "block_size" in config:
        return "dflash"
    if "PEagleDraftModel" in (config.get("architectures") or ()):
        return "peagle"
    return "eagle3"


def load_spec_models(target_model_path: str, draft_export_dir: str, *,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None):
    """The target (floating weights in ``dtype``) and an exported draft,
    loaded once → (target_params, target_config, draft). An SGLang-layout
    export leaves out the frozen embedding; it is taken from the target."""
    device = resolve_device(device)
    target_config = TargetConfig.from_file(target_model_path)
    target_params = load_target_params(target_model_path, target_config,
                                       dtype=dtype, device=device)
    draft = load_exported_draft(
        draft_export_dir,
        fallback_embedding=target_params["model.embed_tokens.weight"],
        device=device)
    return target_params, target_config, draft


def build_decoder(models, capture_layers=None, num_draft_tokens: int = 4,
                  max_len: int = 2048, mesh=None,
                  device: DeviceLike = None) -> Eagle3SpecDecoder:
    """The chain decoder over ``load_spec_models``'s result; capture layers
    by the EAGLE3 rule ``(1, n//2 - 1, n - 4)`` unless given."""
    target_params, target_config, draft = models
    if not isinstance(draft, LlamaEagle3Draft):
        raise ValueError(f"{type(draft).__name__} drafts: {SERVING_LATER}")
    if capture_layers is None:
        n = target_config.num_hidden_layers
        capture_layers = (1, n // 2 - 1, n - 4)
    return Eagle3SpecDecoder(
        target_params, target_config, draft,
        capture_layers=tuple(capture_layers),
        num_draft_tokens=num_draft_tokens, max_len=max_len, mesh=mesh,
        device=device)


@torch.no_grad()
def load_exported_draft(export_dir: str,
                        fallback_embedding: Optional[torch.Tensor] = None, *,
                        device: DeviceLike = None) -> LlamaEagle3Draft:
    """An exported EAGLE3 draft (HF or SGLang layout) as a bf16
    ``LlamaEagle3Draft``, its floating weights stored in bf16 (exports are
    bf16; JAX stores them so too).

    ``fallback_embedding``: [V, H], used when the export leaves out the
    frozen embedding (the SGLang layout). The vocab maps come from the
    export's ``t2d``/``d2t``; a tensor the export lacks keeps its
    initial value, as JAX's loader keeps its template's."""
    with open(os.path.join(export_dir, "config.json")) as f:
        raw = json.load(f)
    family = export_family(raw)
    if family != "eagle3":
        raise ValueError(f"a {family} export: {SERVING_LATER}")
    config = Eagle3Config.from_dict(raw)
    tensors, _ = load_feature_file(os.path.join(export_dir,
                                                "model.safetensors"))
    draft = LlamaEagle3Draft(config, dtype=torch.bfloat16,
                             device=resolve_device(device))
    expected = {**dict(draft.named_parameters()),
                **dict(draft.named_buffers())}
    loaded = draft_state_from_export(tensors, expected)
    if "embed_tokens.weight" not in tensors:
        if fallback_embedding is None:
            raise ValueError(
                "export has no embedding and no fallback_embedding was given")
        want = tuple(expected["embed_tokens.weight"].shape)
        if tuple(fallback_embedding.shape) != want:
            raise ValueError(
                f"fallback embedding shape {tuple(fallback_embedding.shape)} "
                f"vs model {want}")
        loaded["embed_tokens.weight"] = fallback_embedding.float()
    for name, value in loaded.items():
        expected[name].copy_(value)
    # bf16 storage: bit-identical at compute (the exports are bf16), half
    # the bytes a step reads
    return draft.to(torch.bfloat16).eval()
