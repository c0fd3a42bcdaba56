"""Checkpoint export: a port training checkpoint → HF / SGLang serving
directories.

Counterpart of ``specforge_tpu/export/exporter.py``, on the port's
``torch.save`` checkpoints (``{run}-step{N}/state/state.pt``, resolved by
``CheckpointManager.resolve_step_dir``). The serving layout is the JAX
exporter's: torch-convention keys (``layers.N``, ``fc_norm.N``, Domino's
``embed_proj.{0,2}``, the GRU's ``weight_ih_l0``), the merged
``qkv_proj``/``gate_up_proj`` split back into ``q_proj``/``k_proj``/
``v_proj`` and ``gate_proj``/``up_proj``, floating tensors in bf16,
``d2t`` in int64. The port's parameter names are the JAX module names over
torch's [out, in] layout, so :func:`serving_state` renames and splits but
never transposes: it is the inverse of ``models/model_loading.py``
``port_name``. ``model.safetensors`` is written by the port's own
safetensors writer. The required-key checks refuse an export a serving
loader would read as a broken draft.

The tensors are cast and split on CUDA unless the caller names another
device (``device="cpu"``); without a card and without a device named this
raises.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from specforge_tpu_torch.runtime.data_plane.feature_file import save_feature_file
from specforge_tpu_torch.utils import DeviceLike, resolve_device

#: keys the sglang EAGLE3 spec-decoder loader requires in a draft checkpoint.
REQUIRED_SGLANG_KEYS = ("fc.weight", "norm.weight", "lm_head.weight", "t2d", "d2t")

#: backbone keys every DFlash-family serving draft must carry, plus the
#: per-projector auxiliary-head keys.
REQUIRED_SGLANG_KEYS_DFLASH = (
    "fc.weight", "hidden_norm.weight", "norm.weight",
)
_DFLASH_HEAD_KEYS = {
    "domino": (
        "prefix_gru.weight_ih_l0", "prefix_gru.weight_hh_l0",
        "embed_proj.0.weight", "embed_proj.2.weight",
    ),
    "dspark": ("markov_head.markov_w1.weight", "markov_head.markov_w2.weight"),
}
#: dspark method-config fields SGLang's standalone loader reads top-level.
_DSPARK_TOP_LEVEL_FIELDS = (
    "markov_rank", "markov_head_type", "enable_confidence_head",
    "confidence_head_with_markov",
)

#: port name segments → serving segments (the inverse of ``port_name``)
_SEGMENT_FIXUPS = {
    "weight_ih": "weight_ih_l0",
    "weight_hh": "weight_hh_l0",
    "embed_proj_0": "embed_proj.0",
    "embed_proj_1": "embed_proj.2",  # Sequential(Linear, SiLU, Linear)
}
#: merged projections → the serving pieces they split into, in order
_MERGED_PARTS = {
    "qkv_proj": ("q_proj", "k_proj", "v_proj"),
    "gate_up_proj": ("gate_proj", "up_proj"),
}
_DRAFT_KEY = "draft_model"


def _fix_segment(seg: str) -> str:
    if seg in _SEGMENT_FIXUPS:
        return _SEGMENT_FIXUPS[seg]
    for prefix in ("layers_", "fc_norm_"):
        if seg.startswith(prefix) and seg[len(prefix):].isdigit():
            return f"{seg[:len(prefix) - 1]}.{seg[len(prefix):]}"
    return seg


def serving_name(name: str) -> str:
    """A port parameter name (the draft's own, no ``draft_model.``) → its
    serving name."""
    return ".".join(_fix_segment(s) for s in name.split("."))


def serving_state(
    params: Mapping[str, torch.Tensor],
    buffers: Optional[Mapping[str, Any]] = None,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """The draft's tensors by port name → serving tensors (CPU).

    Floating tensors are cast to bf16 on ``device``. ``gate_up_proj``
    splits in equal halves; ``qkv_proj`` takes its q rows from the sibling
    ``o_proj`` weight's input width (= heads · head_dim) and splits the k/v
    remainder in half, as the JAX exporter does. Buffers keep their values,
    ``d2t`` as int64."""
    device = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}

    def emit(name: str, value: torch.Tensor) -> None:
        value = value.to(device)
        if value.is_floating_point():
            value = value.to(torch.bfloat16)
        out[name] = value.contiguous().cpu()

    for name, value in params.items():
        stem, _, leaf = name.rpartition(".")
        base, _, merged = stem.rpartition(".")
        if merged not in _MERGED_PARTS:
            emit(serving_name(name), value)
            continue
        prefix = f"{base}." if base else ""
        if merged == "gate_up_proj":
            sizes = [value.shape[0] // 2] * 2
        else:
            o_proj = params.get(f"{prefix}o_proj.weight")
            if o_proj is None:
                raise ValueError(
                    "qkv_proj export requires a sibling o_proj to derive "
                    f"the q/kv split at {stem}"
                )
            q_rows = o_proj.shape[1]
            kv_rows = (value.shape[0] - q_rows) // 2
            sizes = [q_rows, kv_rows, kv_rows]
        for part, piece in zip(_MERGED_PARTS[merged], value.split(sizes)):
            emit(serving_name(f"{prefix}{part}.{leaf}"), piece)
    for name, value in (buffers or {}).items():
        value = torch.as_tensor(value)
        if name == "d2t":
            value = value.to(torch.int64)
        out[name] = value.contiguous().cpu()
    return out


def load_training_state(checkpoint: str
                        ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(saved payload, contract payload) of a step dir, or of a run root
    with one run (its latest step). The payload is mapped from the file, so
    only the tensors read are paged in."""
    from specforge_tpu_torch.training.checkpoint import (
        STATE_FILE,
        CheckpointManager,
    )

    step_dir = CheckpointManager.resolve_step_dir(checkpoint)
    state = torch.load(os.path.join(step_dir, "state", STATE_FILE),
                       map_location="cpu", weights_only=True, mmap=True)
    with open(os.path.join(step_dir, "contract.json")) as f:
        payload = json.load(f)
    return state, payload


def _extract_draft(state: Mapping[str, Any]
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The draft's parameters and buffers by its own names: those under
    ``draft_model.`` when the training model nests the draft, else all."""

    def draft_part(tree):
        tree = dict(tree or {})
        prefix = f"{_DRAFT_KEY}."
        if any(k.startswith(prefix) for k in tree):
            return {k[len(prefix):]: v for k, v in tree.items()
                    if k.startswith(prefix)}
        return tree

    return draft_part(state.get("params")), draft_part(state.get("buffers"))


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def _vocab_buffers(vocab_mapping_path: str) -> Dict[str, torch.Tensor]:
    from specforge_tpu_torch.training.vocab_mapping import load_vocab_mapping

    t2d, d2t = load_vocab_mapping(vocab_mapping_path)
    return {"t2d": torch.from_numpy(t2d), "d2t": torch.from_numpy(d2t)}


def apply_legacy_rope_scaling(output_dir: str) -> bool:
    """Mirror modern/legacy RoPE scaling config fields on an export.

    Configs written for newer serving stacks carry ``rope_parameters``
    (with ``rope_theta`` inside); older ones read only the legacy
    ``rope_scaling`` dict plus a top-level ``rope_theta``. Mirror whichever
    non-default representation exists into the other, and hoist
    ``rope_theta`` to the top level, so the draft loads identically under
    both. Disabled by ``SPECFORGE_DISABLE_LEGACY_ROPE_SCALING=1``. Returns
    True when the config.json was rewritten.
    """
    if os.environ.get(
        "SPECFORGE_DISABLE_LEGACY_ROPE_SCALING", ""
    ).strip().lower() in ("1", "true", "yes", "on"):
        return False
    config_path = os.path.join(output_dir, "config.json")
    if not os.path.exists(config_path):
        return False
    with open(config_path) as f:
        config = json.load(f)

    modern = config.get("rope_parameters")
    legacy = config.get("rope_scaling")

    def kind(payload) -> Optional[str]:
        if not payload:
            return None
        return payload.get("rope_type") or payload.get("type")

    changed = False
    # modern rope_theta wins over a stale top-level copy
    if modern and "rope_theta" in modern:
        if config.get("rope_theta") != modern["rope_theta"]:
            config["rope_theta"] = modern["rope_theta"]
            changed = True
    if modern and not legacy and kind(modern) not in (None, "default"):
        config["rope_scaling"] = {
            k: v for k, v in modern.items() if k != "rope_theta"
        }
        changed = True
    elif legacy and not modern and kind(legacy) not in (None, "default"):
        mirrored = dict(legacy)
        if "rope_theta" in config:
            mirrored.setdefault("rope_theta", config["rope_theta"])
        config["rope_parameters"] = mirrored
        changed = True
    if not changed:
        return False
    tmp = f"{config_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(config, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, config_path)
    return True


def _write_config(
    output_dir: str, draft_config_path: Optional[str],
    extra: Optional[Dict[str, Any]] = None,
) -> None:
    config: Dict[str, Any] = {}
    if draft_config_path:
        with open(draft_config_path) as f:
            config = json.load(f)
    config.update(extra or {})
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    apply_legacy_rope_scaling(output_dir)


def export_to_sglang(
    checkpoint: str,
    output_dir: str,
    *,
    draft_config_path: Optional[str] = None,
    vocab_mapping_path: Optional[str] = None,
    device: DeviceLike = None,
) -> str:
    """An EAGLE3 or DFlash-family checkpoint → an SGLang draft directory
    (``model.safetensors`` + ``config.json``); EAGLE3's embedding, if the
    state holds one, is left out (the serving draft reads the target's)."""
    device = resolve_device(device)
    state, payload = load_training_state(checkpoint)
    strategy = payload.get("contract", {}).get("strategy")
    if strategy in ("dflash", "domino", "dspark"):
        return _export_dflash_to_sglang(
            state, strategy, output_dir,
            draft_config_path=draft_config_path, device=device,
        )
    if strategy not in (None, "eagle3"):
        raise ValueError(
            "the SGLang exporter supports EAGLE3 and DFlash-family "
            f"checkpoints, got strategy={strategy!r}; use --to hf for "
            "other families"
        )
    draft_params, draft_buffers = _extract_draft(state)
    draft_params = {k: v for k, v in draft_params.items()
                    if "embed" not in _top(k).lower()}
    if vocab_mapping_path:
        draft_buffers = {**draft_buffers, **_vocab_buffers(vocab_mapping_path)}

    serving = serving_state(draft_params, draft_buffers, device=device)
    missing = [k for k in REQUIRED_SGLANG_KEYS if k not in serving]
    if missing:
        raise ValueError(
            f"serving state missing required keys {missing}; the sglang "
            f"loader would silently produce a broken draft. Present: "
            f"{sorted(serving)[:8]}..."
        )
    os.makedirs(output_dir, exist_ok=True)
    save_feature_file(os.path.join(output_dir, "model.safetensors"), serving)
    _write_config(output_dir, draft_config_path)
    return output_dir


def _export_dflash_to_sglang(
    state: Mapping[str, Any],
    strategy: str,
    output_dir: str,
    *,
    draft_config_path: Optional[str] = None,
    device: DeviceLike = None,
) -> str:
    """DFlash-family serving export with the config normalisation SGLang's
    standalone loaders expect: architectures become the serving class,
    DSpark's method fields are hoisted top-level, ``block_size`` must be
    declared, ``auto_map`` is dropped. The drafts carry no embedding (they
    read the target's at serve time), so nothing is stripped."""
    if not draft_config_path:
        raise ValueError(
            "DFlash-family SGLang export needs --draft-config (the serving "
            "config carries block_size + dflash_config)"
        )
    with open(draft_config_path) as f:
        config = json.load(f)
    block_size = config.get("block_size")
    if not isinstance(block_size, int) or block_size <= 1:
        raise ValueError(
            f"DFlash-family export requires integer block_size > 1 in the "
            f"draft config, got {block_size!r}"
        )
    method = dict(config.get("dflash_config") or {})
    projector = method.get("projector_type") or "dflash"
    expected = {"dflash": "dflash", "domino": "domino", "dspark": "dspark"}
    if expected.get(projector) != (
        "dflash" if strategy == "dflash" else strategy
    ):
        raise ValueError(
            f"strategy {strategy!r} does not match "
            f"dflash_config.projector_type={projector!r}"
        )

    draft_params, draft_buffers = _extract_draft(state)
    serving = serving_state(draft_params, draft_buffers, device=device)

    required = list(REQUIRED_SGLANG_KEYS_DFLASH)
    if strategy == "domino":
        required += _DFLASH_HEAD_KEYS["domino"]
    if strategy == "dspark" and method.get("markov_rank", 0) > 0:
        required += _DFLASH_HEAD_KEYS["dspark"]
    missing = [k for k in required if k not in serving]
    if missing:
        raise ValueError(
            f"serving state missing required keys {missing}; the serving "
            f"loader would silently produce a broken draft. Present: "
            f"{sorted(serving)[:8]}..."
        )

    config.pop("auto_map", None)
    if strategy == "dspark":
        rank = method.get("markov_rank", config.get("markov_rank", 0))
        if not isinstance(rank, int) or isinstance(rank, bool) or rank <= 0:
            raise ValueError(
                f"DSpark export requires a positive integer markov_rank, "
                f"got {rank!r}"
            )
        head_type = str(
            method.get("markov_head_type", config.get("markov_head_type"))
            or ""
        ).lower()
        if head_type not in ("vanilla", "gated", "rnn"):
            raise ValueError(
                "DSpark export requires markov_head_type in "
                f"('vanilla', 'gated', 'rnn'), got {head_type!r}"
            )
        for key in _DSPARK_TOP_LEVEL_FIELDS:
            nested = method.get(key)
            if nested is None:
                continue
            top = config.get(key)
            if top is not None and top != nested:
                raise ValueError(
                    f"DSpark config conflict for {key}: top-level {top!r} "
                    f"!= dflash_config {nested!r}"
                )
            config[key] = nested
        config["markov_rank"] = rank
        config["markov_head_type"] = head_type
        config["architectures"] = ["Qwen3DSparkModel"]
    else:
        config["architectures"] = ["DFlashDraftModel"]

    os.makedirs(output_dir, exist_ok=True)
    save_feature_file(os.path.join(output_dir, "model.safetensors"), serving)
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    apply_legacy_rope_scaling(output_dir)
    return output_dir


def export_to_hf(
    checkpoint: str,
    output_dir: str,
    *,
    draft_config_path: Optional[str] = None,
    vocab_mapping_path: Optional[str] = None,
    embedding_source: Optional[str] = None,
    embedding_key: str = "model.embed_tokens.weight",
    device: DeviceLike = None,
) -> str:
    """A self-contained HF-layout directory (reloads with no missing keys),
    for every family.

    A checkpoint without an embedding (EAGLE3 and the DFlash family train
    none) needs ``embedding_source``, the target model directory, so the
    export ships the real table: a random one would silently break
    serving."""
    device = resolve_device(device)
    state, _payload = load_training_state(checkpoint)
    draft_params, draft_buffers = _extract_draft(state)

    has_embedding = any("embed" in _top(k).lower() for k in draft_params)
    serving: Dict[str, torch.Tensor] = {}
    if not has_embedding:
        if not embedding_source:
            raise ValueError(
                "checkpoint has no embed_tokens (draft checkpoints exclude "
                "the frozen embedding); pass embedding_source=<target model "
                "dir> so the export ships the real embedding"
            )
        from specforge_tpu_torch.models.target.head import TargetHead

        embed = TargetHead.from_pretrained(
            embedding_source, lm_head_key=embedding_key
        )
        serving["embed_tokens.weight"] = embed.weight.contiguous()
    if vocab_mapping_path:
        draft_buffers = {**draft_buffers, **_vocab_buffers(vocab_mapping_path)}

    serving.update(serving_state(draft_params, draft_buffers, device=device))
    os.makedirs(output_dir, exist_ok=True)
    save_feature_file(os.path.join(output_dir, "model.safetensors"), serving)
    _write_config(output_dir, draft_config_path)
    return output_dir


def export_checkpoint(
    checkpoint: str,
    output_dir: str,
    fmt: str = "sglang",
    draft_config_path: Optional[str] = None,
    vocab_mapping_path: Optional[str] = None,
    **kwargs,
) -> str:
    if fmt == "sglang":
        return export_to_sglang(
            checkpoint, output_dir, draft_config_path=draft_config_path,
            vocab_mapping_path=vocab_mapping_path, **kwargs,
        )
    if fmt == "hf":
        return export_to_hf(
            checkpoint, output_dir, draft_config_path=draft_config_path,
            vocab_mapping_path=vocab_mapping_path, **kwargs,
        )
    raise ValueError(f"unknown export format {fmt!r}")
