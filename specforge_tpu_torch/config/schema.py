"""Typed run configuration, as dataclasses.

Counterpart of ``specforge_tpu/config/schema.py`` (a pydantic schema there;
pydantic is not on the machine with the card). The same seven sections
(model / data / training / tracking / profiling / runtime / deployment) plus
the run identity, with the same field names and defaults:

- an unknown key raises, as ``extra='forbid'`` does;
- each value is checked against its annotation (``Literal`` choices,
  ``Optional``, int/float/bool/str, lists and dicts) and its bounds
  (``gt``/``ge``/``lt``/``le`` in the field's metadata); an int is accepted
  where a float is declared;
- the cross-field checks of the JAX schema run in ``__post_init__``;
- :func:`load_config` reads JSON (or YAML) and applies dotted ``--set``
  overrides, re-validating the result.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Literal, Optional, Union
from urllib.parse import urlsplit


def _f(default=dataclasses.MISSING, *, factory=None, **bounds):
    """A dataclass field with numeric bounds (gt/ge/lt/le) in its metadata."""
    if factory is not None:
        return field(default_factory=factory, metadata=bounds)
    return field(default=default, metadata=bounds)


class ConfigError(ValueError):
    """A configuration value or key that the schema refuses."""


def _check_value(path: str, value: Any, tp: Any) -> Any:
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if tp is Any:
        return value
    if origin is Union:
        if value is None and type(None) in args:
            return None
        inner = [a for a in args if a is not type(None)]
        if len(inner) == 1:
            return _check_value(path, value, inner[0])
        raise ConfigError(f"{path}: unsupported annotation {tp}")
    if origin is Literal:
        if value not in args:
            raise ConfigError(f"{path}: {value!r} is not one of {list(args)}")
        return value
    if dataclasses.is_dataclass(tp):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected a mapping, got {value!r}")
        return _build(tp, value, path)
    if origin in (list, List):
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected a list, got {value!r}")
        return [_check_value(f"{path}[{i}]", v, args[0] if args else Any)
                for i, v in enumerate(value)]
    if origin in (dict, Dict):
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected a mapping, got {value!r}")
        return dict(value)
    if tp is bool:
        if not isinstance(value, bool):
            raise ConfigError(f"{path}: expected a bool, got {value!r}")
        return value
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigError(f"{path}: expected an int, got {value!r}")
        return value
    if tp is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigError(f"{path}: expected a number, got {value!r}")
        return float(value)
    if tp is str:
        if not isinstance(value, str):
            raise ConfigError(f"{path}: expected a string, got {value!r}")
        return value
    raise ConfigError(f"{path}: unsupported annotation {tp}")


def _check_bounds(path: str, value: Any, bounds: Dict[str, float]) -> None:
    if value is None:
        return
    for op, limit in bounds.items():
        ok = {"gt": value > limit, "ge": value >= limit,
              "lt": value < limit, "le": value <= limit}[op]
        if not ok:
            raise ConfigError(f"{path}: {value!r} must be {op} {limit}")


def _build(cls, data: Dict[str, Any], path: str = ""):
    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - set(fields))
    if unknown:
        raise ConfigError(
            f"{path or cls.__name__}: unknown key(s) {unknown} (extra keys are "
            "forbidden)"
        )
    kwargs = {}
    for name, value in data.items():
        sub = f"{path}.{name}" if path else name
        value = _check_value(sub, value, hints[name])
        _check_bounds(sub, value, dict(fields[name].metadata))
        kwargs[name] = value
    return cls(**kwargs)


class Section:
    """Base of every config section: strict construction from a mapping."""

    @classmethod
    def model_validate(cls, data: Dict[str, Any]):
        return _build(cls, dict(data))

    def model_dump(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class ModelConfig(Section):
    #: HF-style target checkpoint dir (for the frozen head/embeddings) or None
    #: for synthetic/test runs supplying frozen arrays directly.
    target_model_path: Optional[str] = None
    #: draft config: path to a JSON file, or inline dict.
    draft_config_path: Optional[str] = None
    draft_config: Optional[Dict[str, Any]] = None
    #: warm-start draft weights (HF dir or specforge checkpoint).
    draft_checkpoint_path: Optional[str] = None
    #: t2d/d2t vocab-mapping file (.npz); derived for offline eagle3 when
    #: absent.
    vocab_mapping_path: Optional[str] = None
    #: capture-layer override (EAGLE: exactly 3 entries).
    aux_hidden_state_layer_ids: Optional[List[int]] = None
    lm_head_key: str = "lm_head.weight"
    embed_key: str = "model.embed_tokens.weight"
    #: activation/compute dtype for the draft (params stay fp32 masters).
    compute_dtype: Literal["bfloat16", "float32"] = "bfloat16"

    def __post_init__(self):
        if self.draft_config_path and self.draft_config:
            raise ConfigError(
                "model.draft_config_path and model.draft_config are exclusive"
            )


@dataclass
class DataConfig(Section):
    train_data_path: Optional[str] = None
    eval_data_path: Optional[str] = None
    prompt_path: Optional[str] = None
    max_length: int = _f(2048, gt=0)
    chat_template: Optional[str] = None
    train_only_last_turn: bool = False
    num_workers: int = _f(2, ge=0)
    prefetch_batches: int = _f(2, gt=0)
    pack_documents: bool = False
    docs_per_row: int = _f(4, gt=0)


@dataclass
class TrackingConfig(Section):
    backend: str = "jsonl"  # none|stdout|jsonl (comma-join)
    project: Optional[str] = None


@dataclass
class ProfilingSection(Section):
    enabled: bool = False
    start_step: int = _f(10, ge=0)
    num_steps: int = _f(5, gt=0)


@dataclass
class RuntimeConfig(Section):
    store_backend: Literal["memory", "shared_dir", "network"] = "memory"
    store_dir: Optional[str] = None
    control_dir: Optional[str] = None
    max_resident_bytes: Optional[int] = None
    flow_high_watermark: int = _f(256, gt=0)
    flow_low_watermark: int = _f(128, ge=0)
    store_endpoint: Optional[str] = None
    store_secret: Optional[str] = None
    capture_batch_size: int = _f(8, gt=0)
    capture_batch_tokens: int = _f(8192, gt=0)
    inbox_server_port: int = _f(0, ge=0)
    inbox_server_url: Optional[str] = None


@dataclass
class ManagedLocalStackConfig(Section):
    store_max_bytes: int = _f(0, ge=0)
    readiness_timeout_s: float = _f(120.0, gt=0)
    shutdown_grace_s: float = _f(30.0, gt=0)
    capture_layers: Optional[List[int]] = None
    capture_max_length: int = _f(2048, gt=0)
    capture_shard_devices: int = _f(1, ge=0)
    capture_moe_impl: Optional[Literal["dense", "gathered", "ep"]] = None
    capture_moe_capacity_factor: Optional[float] = _f(None, gt=0)

    def __post_init__(self):
        if self.capture_moe_impl == "ep" and self.capture_shard_devices == 1:
            raise ConfigError(
                "capture_moe_impl='ep' needs capture_shard_devices != 1 "
                "(expert tables shard over the capture mesh)"
            )


@dataclass
class DeploymentConfig(Section):
    mode: Literal["colocated", "disaggregated"] = "colocated"
    server_urls: List[str] = _f(factory=list)
    num_producer_workers: int = _f(1, gt=0)
    shutdown_grace_s: float = _f(30.0, gt=0)
    managed_local: Optional[ManagedLocalStackConfig] = None

    def __post_init__(self):
        seen = set()
        for url in self.server_urls:
            parts = urlsplit(url)
            if parts.scheme not in ("http", "https"):
                raise ConfigError(
                    f"deployment.server_urls entries must be http(s) URLs, "
                    f"got {url!r}"
                )
            try:
                port = parts.port
            except ValueError as exc:
                raise ConfigError(
                    f"deployment.server_urls entry {url!r}: {exc}"
                ) from exc
            if port is None:
                raise ConfigError(
                    f"deployment.server_urls entries must carry an explicit "
                    f"port, got {url!r}"
                )
            if url in seen:
                raise ConfigError(f"duplicate capture server URL {url!r}")
            seen.add(url)


@dataclass
class TrainingConfig(Section):
    strategy: str = "eagle3"
    num_epochs: int = _f(1, gt=0)
    total_steps: Optional[int] = _f(None, gt=0)
    batch_size: int = _f(1, gt=0)
    accumulation_steps: int = _f(1, gt=0)
    learning_rate: float = _f(1e-4, gt=0.0)
    weight_decay: float = _f(0.0, ge=0.0)
    lr_scheduler: Literal["cosine", "constant"] = "cosine"
    warmup_ratio: float = _f(0.015, ge=0.0, le=1.0)
    max_grad_norm: float = _f(0.5, gt=0.0)
    adam_b1: float = _f(0.9, ge=0.0, lt=1.0)
    adam_b2: float = _f(0.999, ge=0.0, lt=1.0)
    moments_dtype: Literal["float32", "bfloat16"] = "float32"
    grads_dtype: Literal["float32", "bfloat16"] = "float32"
    #: cast fp32 masters to this dtype once per micro-step instead of at
    #: every use (one low-precision copy per weight kept for the backward)
    compute_params_dtype: Optional[Literal["bfloat16"]] = None
    factored_second_moments: bool = False
    row_sparse_embedding: bool = False
    seed: int = 42

    # --- mesh topology ---
    dp_size: int = _f(1, gt=0)
    fsdp_size: int = _f(0, ge=0)
    sp_ulysses_size: int = _f(1, gt=0)
    sp_ring_size: int = _f(1, gt=0)

    # --- EAGLE3 ---
    ttt_length: int = _f(7, gt=0)
    ploss_decay: float = 0.8
    lk_loss_type: Optional[Literal["lambda", "alpha"]] = None
    kl_scale: float = 1.0
    kl_decay: float = 1.0
    compact_teacher: bool = False
    compact_teacher_chunk_size: int = _f(32768, gt=0)
    attention_backend: Literal["dense", "pallas", "usp"] = "dense"

    # --- DFlash family ---
    num_anchors: int = _f(512, gt=0)
    loss_decay_gamma: Optional[float] = None
    objective_chunk_blocks: int = _f(128, ge=0)
    fused_vocab_objective: bool = True
    loss_type: Literal[
        "dflash", "dpace", "dpace-cumulative-confidence-only",
        "dpace-continuation-value-only",
    ] = "dflash"
    dpace_alpha: float = 0.5
    lambda_base_start: float = 1.0
    lambda_base_decay_ratio: float = 0.5
    dspark_ce_loss_alpha: float = 0.1
    dspark_l1_loss_alpha: float = 0.9
    dspark_confidence_head_alpha: float = 1.0
    mask_token_id: Optional[int] = None

    # --- P-EAGLE ---
    num_depths: int = _f(8, gt=0)
    down_sample_ratio: float = 0.8
    down_sample_ratio_min: float = 0.2

    # --- intervals / checkpoints ---
    save_interval: int = _f(0, ge=0)
    eval_interval: int = _f(0, ge=0)
    log_interval: int = _f(50, gt=0)
    max_checkpoints: int = _f(5, ge=0)
    resume: bool = False
    resume_from: Optional[str] = None
    role: Literal["auto", "all", "producer", "consumer"] = "all"

    def __post_init__(self):
        if not 0.0 <= self.dpace_alpha <= 1.0:
            raise ConfigError("training.dpace_alpha must be in [0, 1]")
        if not 0.0 < self.down_sample_ratio <= 1.0:
            raise ConfigError("training.down_sample_ratio must be in (0, 1]")
        if not 0.0 < self.down_sample_ratio_min <= self.down_sample_ratio:
            raise ConfigError(
                "training.down_sample_ratio_min must be in "
                "(0, training.down_sample_ratio]"
            )
        sp = self.sp_ulysses_size * self.sp_ring_size
        if self.attention_backend == "usp":
            # one row per batch block, as the JAX package's batch_size=1
            # for its one block
            if self.batch_size != self.dp_size * max(self.fsdp_size, 1):
                raise ConfigError(
                    "USP takes one row per batch block: training.batch_size "
                    "must be dp_size * fsdp_size (1 without them)")
            if sp <= 1:
                raise ConfigError(
                    "USP requires sp_ulysses_size * sp_ring_size > 1"
                )
        elif sp != 1:
            raise ConfigError(
                "sp_ulysses_size/sp_ring_size require attention_backend=usp"
            )
        if self.resume_from is not None and self.role == "producer":
            raise ConfigError(
                "training.resume_from is valid only for a trainer role"
            )


@dataclass
class Config(Section):
    run_id: str = "run"
    output_dir: str = "runs"
    model: ModelConfig = _f(factory=ModelConfig)
    data: DataConfig = _f(factory=DataConfig)
    training: TrainingConfig = _f(factory=TrainingConfig)
    tracking: TrackingConfig = _f(factory=TrackingConfig)
    profiling: ProfilingSection = _f(factory=ProfilingSection)
    runtime: RuntimeConfig = _f(factory=RuntimeConfig)
    deployment: DeploymentConfig = _f(factory=DeploymentConfig)

    def __post_init__(self):
        online = bool(self.deployment.server_urls) or (
            self.training.role in ("producer", "consumer")
        )
        if online and self.deployment.mode != "disaggregated":
            raise ConfigError(
                "online runs (server_urls / producer / consumer roles) "
                "require deployment.mode=disaggregated"
            )
        if (self.runtime.store_backend == "shared_dir"
                and not self.runtime.store_dir):
            raise ConfigError(
                "runtime.store_backend=shared_dir requires runtime.store_dir"
            )
        if (self.runtime.store_backend == "network"
                and not self.runtime.store_endpoint):
            raise ConfigError(
                "runtime.store_backend=network requires runtime.store_endpoint"
            )
        if (self.training.resume_from is not None
                and self.model.draft_checkpoint_path is not None):
            raise ConfigError(
                "model.draft_checkpoint_path (weights-only warm start) and "
                "training.resume_from (full resume) are mutually exclusive"
            )


def _parse_scalar(raw: str) -> Any:
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        return raw


def apply_overrides(config: Config, overrides: List[str]) -> Config:
    """Apply ``a.b.c=value`` dotted overrides; the result re-validates."""
    data = config.model_dump()
    for item in overrides:
        if "=" not in item:
            raise ConfigError(f"override {item!r} must be key=value")
        key, raw = item.split("=", 1)
        parts = key.strip().split(".")
        node = data
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = _parse_scalar(raw)
    return Config.model_validate(data)


def load_config(path: str, overrides: Optional[List[str]] = None) -> Config:
    """Load a JSON (or YAML) config + dotted overrides."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml

        data = yaml.safe_load(text) or {}
    else:
        data = json.loads(text)
    config = Config.model_validate(data)
    if overrides:
        config = apply_overrides(config, overrides)
    return config
