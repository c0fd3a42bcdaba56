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
  in fp32 each step (the JAX package's ``_scale_by_adam_lowp_moments``);
- ``factored_second_moments`` keeps, for a tensor with ndim >= 2 and both
  trailing dims >= ``factored_min_dim``, row and column EMAs of g² instead
  of a dense second moment, ``nu_hat = R C^T / sum(R)`` (Adafactor's
  factorisation inside Adam: ``_scale_by_factored_adam``); the row and
  column EMAs stay fp32 whatever ``moments_dtype`` is, and with
  ``adam_b1 == 0`` no first moment is kept at all;
- ``row_sparse_embedding`` (which needs factored moments, ``adam_b1 = 0``
  and ``weight_decay = 0``, so that untouched rows get exactly no update)
  updates only the embedding rows a window touched
  (:func:`sparse_embed_update`), from their gradients summed per row
  (:func:`segment_sum_rows`); the train step forms no dense [V, H]
  gradient on that path.

Parameters *are* the fp32 masters; the update is applied to them in place,
which saves a second copy of every master. Under fsdp (``shards``, a
:class:`~specforge_tpu_torch.parallel.fsdp.ShardPlan`) each rank holds and
updates its slices of the masters and moments; each sum that covers a whole
tensor (the global norm, a factored statistic summed along a sharded
dimension, the row sum of a sharded ``nu_row``) is summed over the fsdp
group, and a whole tensor enters the global norm once. Frozen leaves (the
target-copied embedding) are not handed to the optimizer at all: they get
no state and no update, as under optax's ``multi_transform`` with
``set_to_zero``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

Tensors = Dict[str, torch.Tensor]

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
    #: Adafactor-style rank-1 second moments for large matrices
    factored_second_moments: bool = False
    factored_min_dim: int = 128
    #: update only the embedding rows a window touched (P-EAGLE)
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


def global_norm(grads: Mapping[str, torch.Tensor], shards=None
                ) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (fp32 scalar). Under
    ``shards`` the squares of the sharded tensors' slices are summed over
    the fsdp group; a whole tensor is counted once."""
    total = part = None
    for name, g in grads.items():
        sq = torch.sum(g.float() * g.float())
        if shards is not None and shards.dim(name) is not None:
            part = sq if part is None else part + sq
        else:
            total = sq if total is None else total + sq
    if part is not None:
        part = shards.fsdp_sum(part)
        total = part if total is None else total + part
    return torch.sqrt(total)


def clip_by_global_norm(
    grads: Tensors, max_norm: float, norm: Optional[torch.Tensor] = None,
    shards=None,
) -> Tensors:
    """``g · max_norm / ‖g‖`` when ``‖g‖ ≥ max_norm``, else ``g`` unchanged."""
    norm = global_norm(grads, shards) if norm is None else norm
    trigger = norm < max_norm
    return {k: torch.where(trigger, g, (g / norm) * max_norm)
            for k, g in grads.items()}


class AdamW:
    """Clip-by-global-norm → AdamW with the warmup schedule
    (``build_optimizer`` of the JAX package). State is a plain dict:
    ``{"count": int, "mu": {name: tensor}, "nu": {...}, "nu_row": {...},
    "nu_col": {...}}``; each moment dict holds the tensors that keep that
    moment (``nu_row``/``nu_col`` only the factored ones, ``mu`` none when
    factored with ``adam_b1 == 0``)."""

    def __init__(self, config: OptimizerConfig, total_steps: int):
        if config.row_sparse_embedding and (
            not config.factored_second_moments
            or config.adam_b1 != 0.0
            or config.weight_decay != 0.0
        ):
            raise ValueError(
                "row_sparse_embedding requires factored_second_moments=True, "
                "adam_b1=0 and weight_decay=0 (untouched rows must receive "
                "exactly zero update for the sparse path to equal the dense "
                "one)"
            )
        if config.moments_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported moments_dtype {config.moments_dtype!r}")
        self.config = config
        self.schedule = build_lr_schedule(config, total_steps)
        self.moments_dtype = getattr(torch, config.moments_dtype)

    def is_factored(self, p: torch.Tensor) -> bool:
        """Whether ``p`` (at its whole shape) keeps factored moments."""
        return (self.config.factored_second_moments and p.dim() >= 2
                and min(p.shape[-2:]) >= self.config.factored_min_dim)

    def init(self, params: Mapping[str, torch.Tensor]) -> dict:
        dt = self.moments_dtype
        keep_mu = not (self.config.factored_second_moments
                       and self.config.adam_b1 == 0.0)
        fact = {k: p for k, p in params.items() if self.is_factored(p)}
        return {
            "count": 0,
            "mu": ({k: torch.zeros_like(p, dtype=dt)
                    for k, p in params.items()} if keep_mu else {}),
            "nu": {k: torch.zeros_like(p, dtype=dt)
                   for k, p in params.items() if k not in fact},
            "nu_row": {k: torch.zeros(p.shape[:-1], device=p.device)
                       for k, p in fact.items()},
            "nu_col": {k: torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      device=p.device)
                       for k, p in fact.items()},
        }

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor], grads: Tensors,
             state: dict, grad_norm: Optional[torch.Tensor] = None,
             clip: bool = True, shards=None) -> dict:
        """Apply one update to ``params`` in place → the new state.
        ``grads`` are fp32; ``grad_norm`` (their global norm) is reused by
        the clip when given; ``clip=False`` takes grads the caller has
        clipped already (the row-sparse path, whose norm spans the
        embedding rows too). Under ``shards`` the parameters, gradients and
        moments are this rank's slices."""
        cfg = self.config
        if clip:
            grads = clip_by_global_norm(grads, cfg.max_grad_norm, grad_norm,
                                        shards)
        b1, b2, eps, wd = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps, cfg.weight_decay
        count = state["count"] + 1
        c = torch.tensor(float(count), dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** c
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** c
        lr = -self.schedule(state["count"])
        lowp = self.moments_dtype != torch.float32
        new = {"count": count, "mu": {}, "nu": {}, "nu_row": {}, "nu_col": {}}
        for name, p in params.items():
            g = grads[name]
            bc1d, bc2d = bc1.to(p.device), bc2.to(p.device)
            if cfg.factored_second_moments:
                u = self._factored(name, g, state, new, bc1d, bc2d, shards)
            elif lowp:
                mu = (b1 * state["mu"][name].float() + (1 - b1) * g).to(
                    self.moments_dtype)
                nu = (b2 * state["nu"][name].float() + (1 - b2) * g * g).to(
                    self.moments_dtype)
                u = (mu.float() / bc1d) / (torch.sqrt(nu.float() / bc2d) + eps)
                new["mu"][name], new["nu"][name] = mu, nu
            else:
                mu = (1 - b1) * g + b1 * state["mu"][name]
                nu = (1 - b2) * (g * g) + b2 * state["nu"][name]
                u = (mu / bc1d) / (torch.sqrt(nu / bc2d) + eps)
                new["mu"][name], new["nu"][name] = mu, nu
            u = u + wd * p
            p.add_(torch.tensor(lr, dtype=torch.float32, device=p.device) * u)
        return new

    def _factored(self, name, g, state, new, bc1, bc2, shards=None
                  ) -> torch.Tensor:
        """The update of one tensor under factored second moments
        (``_scale_by_factored_adam``), its new moments into ``new``. A sum
        along a dimension ``shards`` splits is summed over the fsdp
        group."""
        b1, b2, eps = self.config.adam_b1, self.config.adam_b2, self.config.adam_eps
        f32, dt = torch.float32, self.moments_dtype
        mhat = g
        if b1 > 0.0:
            mu = (b1 * state["mu"][name].to(f32) + (1 - b1) * g).to(dt)
            new["mu"][name] = mu
            mhat = mu.to(f32) / bc1
        if name in state["nu_row"]:
            d = shards.dim(name) if shards is not None else None
            n = g.dim()

            def whole(x, along):  # a sum along dim ``along`` of g
                return shards.fsdp_sum(x) if d == along else x

            gg = g * g
            r = b2 * state["nu_row"][name] + (1 - b2) * whole(
                gg.sum(dim=-1), n - 1)
            cv = b2 * state["nu_col"][name] + (1 - b2) * whole(
                gg.sum(dim=-2), n - 2)
            new["nu_row"][name], new["nu_col"][name] = r, cv
            denom = torch.clamp(
                whole(r.sum(dim=-1, keepdim=True), n - 2)[..., None],
                min=1e-30)
            vhat = (r[..., :, None] * cv[..., None, :]) / denom
        else:
            nu = (b2 * state["nu"][name].to(f32) + (1 - b2) * g * g).to(dt)
            new["nu"][name] = nu
            vhat = nu.to(f32)
        return mhat / (torch.sqrt(vhat / bc2) + eps)


def init_sparse_embed_state(table: torch.Tensor) -> dict:
    """Factored-Adam state of a row-sparse-updated [V, H] table: O(V) + O(H)
    vectors, ``{"count": int, "nu_row": [V] fp32, "nu_col": [H] fp32}``."""
    v, h = table.shape
    return {"count": 0,
            "nu_row": torch.zeros(v, device=table.device),
            "nu_col": torch.zeros(h, device=table.device)}


def segment_sum_rows(ids: torch.Tensor, rows: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum the rows of duplicate ids → (unique ids [U] ascending, summed
    rows [U, H]). The rows of each id are added in their order, one
    sequential sum per output element (``segment_reduce``), so two runs
    give the same bits on any device."""
    ids = ids.reshape(-1).to(torch.int64)
    order = torch.argsort(ids, stable=True)
    uids, counts = torch.unique_consecutive(ids[order], return_counts=True)
    summed = torch.segment_reduce(rows[order], "sum", lengths=counts, axis=0)
    return uids, summed


@torch.no_grad()
def sparse_embed_update(config: OptimizerConfig, schedule: Callable,
                        state: dict, table: torch.Tensor, uids: torch.Tensor,
                        g_rows: torch.Tensor,
                        table_slice: Optional[Tuple[int, int, int]] = None
                        ) -> dict:
    """One factored-Adam step on the ``uids`` rows of ``table`` (the fp32
    master, updated in place) from their summed, normalised and
    clip-scaled gradients ``g_rows`` [U, H] → the new state. Untouched rows
    get no update (the dense path's g = 0 there) while their ``nu_row``
    decays by b2, as in the dense factored step. ``table_slice = (dim, lo,
    n)``: ``table`` is the [lo, lo + n) slice of the whole table along
    ``dim`` (an fsdp shard); the state and the rows stay whole, so every
    rank computes the same update and applies its own slice of it."""
    b2, eps = config.adam_b2, config.adam_eps
    count = state["count"] + 1
    c = torch.tensor(float(count), dtype=torch.float32)
    bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** c).to(table.device)
    gg = g_rows * g_rows
    nu_row = b2 * state["nu_row"]
    nu_row.index_add_(0, uids, (1.0 - b2) * gg.sum(dim=1))
    nu_col = b2 * state["nu_col"] + (1.0 - b2) * gg.sum(dim=0)
    denom = torch.clamp(nu_row.sum(), min=1e-30)
    vhat = nu_row[uids][:, None] * nu_col[None, :] / denom
    update = g_rows / (torch.sqrt(vhat / bc2) + eps)
    lr = torch.tensor(schedule(state["count"]), dtype=torch.float32,
                      device=table.device)
    rows = uids
    if table_slice is not None:
        dim, lo, n = table_slice
        if dim == 0:
            mine = (uids >= lo) & (uids < lo + n)
            rows, update = uids[mine] - lo, update[mine]
        else:
            update = update[:, lo:lo + n]
    table.index_add_(0, rows, -lr * update)
    return {"count": count, "nu_row": nu_row, "nu_col": nu_col}


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
