"""Serving loaders: a target and an exported draft, loaded for a decoder.

Counterpart of ``specforge_tpu/inference/serving_loaders.py``: the target
read from its HF safetensors (no conversion), an exported draft read by
the port's own safetensors reader and mapped by
``models/model_loading.draft_state_from_export``, its floating weights
stored in bf16 as JAX stores them, and the decoder built over both: the
EAGLE3 chain decoder for an EAGLE3 export (HF or SGLang layout), the block
decoder for a DFlash-family SGLang export (DFlash, Domino, DSpark). Used by
the HTTP endpoint (``serving_server_main.py``).

P-EAGLE exports are refused by name: their decoder and loader come with
``ROADMAP.md`` Queue 1 item 8b.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from specforge_tpu_torch.inference.spec_decode import (
    PEAGLE_LATER,
    DFlashSpecDecoder,
    Eagle3SpecDecoder,
)
from specforge_tpu_torch.models.draft.dflash import (
    DFlashConfig,
    DFlashDraftModel,
)
from specforge_tpu_torch.models.draft.domino import DominoDraftModel
from specforge_tpu_torch.models.draft.dspark import DSparkDraftModel
from specforge_tpu_torch.models.draft.llama_eagle3 import (
    Eagle3Config,
    LlamaEagle3Draft,
)
from specforge_tpu_torch.models.draft.peagle import PEagleDraftModel
from specforge_tpu_torch.models.model_loading import draft_state_from_export
from specforge_tpu_torch.models.target.transformer import (
    TargetConfig,
    load_target_params,
)
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    read_safetensors_keys,
    read_safetensors_tensors,
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


def read_export_family(export_dir: str) -> str:
    """``export_family`` of the ``config.json`` in ``export_dir``."""
    with open(os.path.join(export_dir, "config.json")) as f:
        return export_family(json.load(f))


def load_spec_models(target_model_path: str, draft_export_dir: str, *,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None):
    """The target (floating weights in ``dtype``) and an exported draft,
    loaded once → (target_params, target_config, draft). An EAGLE3
    SGLang-layout export leaves out the frozen embedding; it is taken from
    the target (a DFlash-family draft reads the target's at serve time)."""
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
                  max_len: int = 2048, mesh=None, device: DeviceLike = None):
    """The decoder over ``load_spec_models``'s result: the block decoder
    for a DFlash-family draft (capture layers and block size from its
    config), else the chain decoder with capture layers by the EAGLE3 rule
    ``(1, n//2 - 1, n - 4)`` unless given."""
    target_params, target_config, draft = models
    if isinstance(draft, DFlashDraftModel):
        wanted = tuple(draft.config.resolved_target_layer_ids)
        if capture_layers is not None and tuple(capture_layers) != wanted:
            raise ValueError(f"capture layers {tuple(capture_layers)}: the "
                             f"draft reads {wanted}")
        return DFlashSpecDecoder(target_params, target_config, draft,
                                 max_len=max_len, mesh=mesh, device=device)
    if isinstance(draft, PEagleDraftModel):
        raise ValueError(f"a P-EAGLE draft: {PEAGLE_LATER}")
    if not isinstance(draft, LlamaEagle3Draft):
        raise ValueError(f"{type(draft).__name__} drafts are not served: "
                         "EAGLE3 and DFlash-family drafts are")
    if capture_layers is None:
        n = target_config.num_hidden_layers
        capture_layers = (1, n // 2 - 1, n - 4)
    return Eagle3SpecDecoder(
        target_params, target_config, draft,
        capture_layers=tuple(capture_layers),
        num_draft_tokens=num_draft_tokens, max_len=max_len, mesh=mesh,
        device=device)


def read_export(export_dir: str) -> dict:
    """An export's ``model.safetensors`` as CPU tensors: its bytes read in
    one go, each tensor a view of them."""
    path = os.path.join(export_dir, "model.safetensors")
    return read_safetensors_tensors(path, read_safetensors_keys(path))


@torch.no_grad()
def load_exported_draft(export_dir: str,
                        fallback_embedding: Optional[torch.Tensor] = None, *,
                        device: DeviceLike = None) -> LlamaEagle3Draft:
    """An exported EAGLE3 draft (HF or SGLang layout) as a bf16
    ``LlamaEagle3Draft``, its floating weights stored in bf16 (exports are
    bf16; JAX stores them so too); a DFlash-family export goes to
    ``load_exported_dflash_draft``.

    ``fallback_embedding``: [V, H], used when the export leaves out the
    frozen embedding (the SGLang layout). The vocab maps come from the
    export's ``t2d``/``d2t``; a tensor the export lacks keeps its
    initial value, as JAX's loader keeps its template's."""
    with open(os.path.join(export_dir, "config.json")) as f:
        raw = json.load(f)
    family = export_family(raw)
    if family == "peagle":
        raise ValueError(f"a peagle export: {PEAGLE_LATER}")
    if family == "dflash":
        return load_exported_dflash_draft(export_dir, device=device)
    config = Eagle3Config.from_dict(raw)
    tensors = read_export(export_dir)
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


#: a DFlash-family export's ``dflash_config.projector_type`` → its draft
DFLASH_DRAFTS = {
    "dflash": DFlashDraftModel,
    "domino": DominoDraftModel,
    "dspark": DSparkDraftModel,
}


@torch.no_grad()
def load_exported_dflash_draft(export_dir: str, *,
                               device: DeviceLike = None) -> DFlashDraftModel:
    """A DFlash-family SGLang export (``config.json`` with ``dflash_config``
    nested, ``model.safetensors``) as a bf16 draft for block speculation.

    ``projector_type`` picks the class (the export's ``architectures``
    carry serving names such as ``Qwen3DSparkModel``). Every weight is
    filled, the Domino GRU and ``embed_proj`` and the DSpark Markov and
    confidence heads included, the exporter's split q/k/v (gate/up) merged
    back; a tensor the export lacks, or one of the wrong shape, raises with
    its name. Floating weights are stored in bf16, as JAX stores them."""
    with open(os.path.join(export_dir, "config.json")) as f:
        raw = json.load(f)
    projector = (raw.get("dflash_config") or {}).get("projector_type") or (
        "dflash")
    if projector not in DFLASH_DRAFTS:
        raise ValueError(f"projector_type {projector!r} not in "
                         f"{sorted(DFLASH_DRAFTS)}")
    config = DFlashConfig.from_dict(raw)
    tensors = read_export(export_dir)
    draft = DFLASH_DRAFTS[projector](config, dtype=torch.bfloat16,
                                     device=resolve_device(device))
    expected = {**dict(draft.named_parameters()),
                **dict(draft.named_buffers())}
    loaded = draft_state_from_export(tensors, expected)
    missing = sorted(set(expected) - set(loaded))
    if missing:
        raise ValueError(f"the export in {export_dir} lacks {missing}")
    for name, value in loaded.items():
        expected[name].copy_(value)
    return draft.to(torch.bfloat16).eval()
