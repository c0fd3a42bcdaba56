"""AdamW on fp32 masters, global-norm clipping and the LR schedule.

Counterpart of ``specforge_tpu/training/optimizer.py``, written as plain
functions on tensors with optax's semantics (not ``torch.optim.AdamW`` and
``clip_grad_norm_``, which differ):

- clip by global norm: ``g · max_norm / ‖g‖`` only when ``‖g‖ ≥ max_norm``,
  with no epsilon (``optax.clip_by_global_norm``);
- Adam moments ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``, bias
  corrected by ``1 - b^count`` at the incremented count, update
  ``mu_hat / (sqrt(nu_hat) + eps)`` (``optax.scale_by_adam``); then
  ``+ weight_decay · p`` and ``· -lr`` with the schedule read at the count
  *before* the increment (``optax.scale_by_learning_rate``);
- ``moments_dtype="bfloat16"`` stores both moments in bf16 and accumulates
  in fp32 each step (the JAX package's ``_scale_by_adam_lowp_moments``).

Parameters *are* the fp32 masters; the update is applied to them in place,
which saves a second copy of every master. Frozen leaves (the
target-copied embedding) are not handed to the optimizer at all: they get
no state and no update, as under optax's ``multi_transform`` with
``set_to_zero``. Factored second moments and the row-sparse embedding
update belong to P-EAGLE and come with that slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

Tensors = Dict[str, torch.Tensor]

P_EAGLE_SLICE = "the P-EAGLE slice (ROADMAP.md, Queue 1 item 5)"


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    weight_decay: float = 0.0
    max_grad_norm: float = 0.5
    warmup_ratio: float = 0.015
    lr_scheduler: str = "cosine"  # cosine | constant
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    #: dtype of the Adam first/second moments ("float32" or "bfloat16");
    #: fp32 masters are kept either way
    moments_dtype: str = "float32"
    #: Adafactor-style factored second moments (P-EAGLE; not ported yet)
    factored_second_moments: bool = False
    #: row-sparse embedding update (P-EAGLE; not ported yet)
    row_sparse_embedding: bool = False


def build_lr_schedule(config: OptimizerConfig, total_steps: int) -> Callable:
    """Linear warmup over ``warmup_ratio * total_steps`` then cosine/constant.

    Returns ``schedule(step) -> float``, computed in float32 as the JAX
    package does. Warmup is the ``(step + 1) / warmup_steps`` ramp; cosine
    anneals to 0 over the remaining steps."""
    if config.lr_scheduler not in ("cosine", "constant"):
        raise ValueError(f"unsupported lr_scheduler={config.lr_scheduler!r}")
    warmup_steps = int(config.warmup_ratio * total_steps)
    f32 = np.float32
    base_lr = f32(config.lr)

    def schedule(step) -> float:
        step = f32(int(step))
        if step < warmup_steps:
            return float(min((step + f32(1.0)) / f32(warmup_steps), f32(1.0))
                         * base_lr)
        if config.lr_scheduler == "constant":
            return float(base_lr)
        t = np.clip((step - f32(warmup_steps))
                    / f32(max(total_steps - warmup_steps, 1)), f32(0.0),
                    f32(1.0))
        return float(base_lr * f32(0.5)
                     * (f32(1.0) + np.cos(f32(math.pi) * t, dtype=f32)))

    return schedule


def global_norm(grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (fp32 scalar)."""
    total = None
    for g in grads.values():
        sq = torch.sum(g.float() * g.float())
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(
    grads: Tensors, max_norm: float, norm: Optional[torch.Tensor] = None
) -> Tensors:
    """``g · max_norm / ‖g‖`` when ``‖g‖ ≥ max_norm``, else ``g`` unchanged."""
    norm = global_norm(grads) if norm is None else norm
    trigger = norm < max_norm
    return {k: torch.where(trigger, g, (g / norm) * max_norm)
            for k, g in grads.items()}


class AdamW:
    """Clip-by-global-norm → AdamW with the warmup schedule
    (``build_optimizer`` of the JAX package). State is a plain dict:
    ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``."""

    def __init__(self, config: OptimizerConfig, total_steps: int):
        if config.factored_second_moments or config.row_sparse_embedding:
            raise NotImplementedError(
                "factored second moments and the row-sparse embedding update "
                f"are not ported yet; they come with {P_EAGLE_SLICE}"
            )
        if config.moments_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported moments_dtype {config.moments_dtype!r}")
        self.config = config
        self.schedule = build_lr_schedule(config, total_steps)
        self.moments_dtype = getattr(torch, config.moments_dtype)

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        def zeros():
            return {k: torch.zeros_like(p, dtype=self.moments_dtype)
                    for k, p in params.items()}

        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Tensors,
             state: dict, grad_norm: Optional[torch.Tensor] = None) -> dict:
        """Apply one update to ``params`` in place → the new state.
        ``grads`` are fp32; ``grad_norm`` (their global norm) is reused by
        the clip when given."""
        cfg = self.config
        grads = clip_by_global_norm(grads, cfg.max_grad_norm, grad_norm)
        b1, b2, eps, wd = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps, cfg.weight_decay
        count = state["count"] + 1
        c = torch.tensor(float(count), dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** c
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** c
        lr = -self.schedule(state["count"])
        lowp = self.moments_dtype != torch.float32
        mu_new, nu_new = {}, {}
        for name, p in params.items():
            g = grads[name]
            bc1d, bc2d = bc1.to(p.device), bc2.to(p.device)
            if lowp:
                mu = (b1 * state["mu"][name].float() + (1 - b1) * g).to(
                    self.moments_dtype)
                nu = (b2 * state["nu"][name].float() + (1 - b2) * g * g).to(
                    self.moments_dtype)
                u = (mu.float() / bc1d) / (torch.sqrt(nu.float() / bc2d) + eps)
            else:
                mu = (1 - b1) * g + b1 * state["mu"][name]
                nu = (1 - b2) * (g * g) + b2 * state["nu"][name]
                u = (mu / bc1d) / (torch.sqrt(nu / bc2d) + eps)
            u = u + wd * p
            p.add_(torch.tensor(lr, dtype=torch.float32, device=p.device) * u)
            mu_new[name], nu_new[name] = mu, nu
        return {"count": count, "mu": mu_new, "nu": nu_new}


def build_optimizer(config: OptimizerConfig, total_steps: int) -> AdamW:
    return AdamW(config, total_steps)


def embedding_freeze_mask(module: nn.Module, freeze_embedding: bool = True
                          ) -> Dict[str, bool]:
    """True = trainable. Freezes every parameter whose name contains
    'embed' (the EAGLE3 target-copied embedding contract)."""
    return {
        name: not (freeze_embedding and "embed" in name.lower())
        for name, _ in module.named_parameters()
    }


@torch.no_grad()
def cast_frozen_to(module: nn.Module, trainable_mask: Mapping[str, bool],
                   dtype: torch.dtype) -> None:
    """Cast frozen (mask False) floating parameters to ``dtype`` in place
    and stop their gradients: a frozen table needs no fp32 master."""
    for name, p in module.named_parameters():
        if not trainable_mask.get(name, True) and p.is_floating_point():
            p.data = p.data.to(dtype)
            p.requires_grad_(False)


def split_trainable(module: nn.Module, trainable_mask: Optional[Mapping[str, bool]]
                    ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """The module's parameters as (trainable, frozen) name → parameter."""
    train, frozen = {}, {}
    for name, p in module.named_parameters():
        if trainable_mask is None or trainable_mask.get(name, True):
            train[name] = p
        else:
            frozen[name] = p
    return train, frozen
