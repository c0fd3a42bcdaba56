"""The train step: micro-step accumulation, then one optimizer update.

Counterpart of ``specforge_tpu/training/train_step.py`` without ``jit``:
PyTorch runs eagerly, so the micro-steps are a Python loop and the
optimizer step is explicit.

- The batch carries a leading micro-step axis ``[accum, per_micro_batch,
  ...]`` (``accum=1`` for single-micro steps), as in the JAX package.
- Each micro-step's gradients come from ``torch.autograd.grad`` on the
  trainable fp32 masters, are stored in ``grads_dtype`` and summed in it;
  the optimizer math runs in fp32 after one division: by ``accum_steps``,
  or, for a strategy that declares ``uses_loss_terms`` (DFlash), by the
  ``loss_terms`` denominator summed over the window's micro-steps (clamped
  at 1e-6), the gradient then coming from the numerator.
- Ratio metrics accumulate as (numerator, denominator) pairs and divide once.
- ``compute_params_dtype`` casts the fp32 masters to that dtype once per
  micro-step (``torch.func.functional_call`` over the cast copies) instead
  of at every use; autograd then keeps one low-precision copy of each weight
  instead of one per TTT step, and the weight gradients are summed in that
  dtype over the steps before the fp32 convert-back, as in the JAX package.
  A strategy's trainable embedding table (``sparse_embed_path``) is not
  cast: the model gathers its fp32 rows and casts those.
- With a :class:`SparseEmbedPlan` (``row_sparse_embedding``), the embedding
  table is kept out of the tensors ``torch.autograd.grad`` targets; a zero
  fp32 ``embed_delta`` [B, T, H] that requires grad is added to the sampled
  embeddings, and its gradient is the per-position embedding gradient. The
  ids and rows of the window's micro-steps are concatenated, divided by the
  norm and summed per id (``segment_sum_rows``); the global norm spans the
  dense gradients and those rows, one clip scale serves both; then the
  dense factored step, then the sparse one. No dense [V, H] gradient is
  formed on this path.
- With a ``mesh`` of more than one rank (dp, fsdp, USP or a mix), each
  rank's gradients are its own batch block's and sequence chunk's share of
  the global loss (the model sums every loss and metric over the ranks).
  A :class:`~specforge_tpu_torch.parallel.fsdp.ShardPlan` sums them over
  all ranks once per window, before the division, the global norm and the
  clip (fp32, one parameter at a time): reduce-scattered over the fsdp
  group and summed over the replica group when the parameter is sharded,
  summed over every rank when it is whole. Under fsdp each micro-step
  gathers the sharded parameters, cast first, into whole tensors and
  differentiates with respect to those (an embedding table the strategy
  only looks rows up in, ``lookup_ids``, moves just those rows); the
  optimizer updates this rank's slices. On the row-sparse path every rank
  gathers the touched ids and rows of every rank, in (micro-step, rank)
  order, the order of one process's batch. Every rank of a replica group
  takes the same steps, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from specforge_tpu_torch.training.optimizer import (
    AdamW,
    OptimizerConfig,
    global_norm,
    init_sparse_embed_state,
    segment_sum_rows,
    sparse_embed_update,
    split_trainable,
)
from specforge_tpu_torch.parallel.fsdp import ShardPlan
from specforge_tpu_torch.training.strategies import StepContext
from specforge_tpu_torch.utils import model_device


@dataclass(frozen=True)
class SparseEmbedPlan:
    """The row-sparse embedding update of a run: ``path`` names the
    embedding table among the model's parameters; ``delta_shape_fn`` maps a
    micro-batch's tensors to the [B, T, H] shape of its ``embed_delta``;
    ``opt_config`` and ``schedule`` drive the row update."""

    path: str
    delta_shape_fn: Callable
    opt_config: OptimizerConfig
    schedule: Callable


@dataclass
class TrainState:
    """The trainable fp32 masters (the model's own parameters), the model's
    buffers, the optimizer state and the number of optimizer steps taken."""

    params: Dict[str, nn.Parameter]
    buffers: Dict[str, torch.Tensor]
    opt_state: dict
    step: int

    @classmethod
    def create(cls, model: nn.Module, optimizer: AdamW,
               trainable_mask: Optional[Mapping[str, bool]] = None,
               sparse_embed_path: Optional[str] = None,
               shards: Optional[ShardPlan] = None) -> "TrainState":
        """Optimizer state for the trainable parameters; with
        ``sparse_embed_path`` the table named there gets the sparse state
        (``{"dense": ..., "sparse_embed": ...}``) and the rest the dense.
        With a sharding ``shards`` (the model already sharded) the state
        is made for the whole shapes and each rank keeps its slices."""
        trainable, _frozen = split_trainable(model, trainable_mask)
        sharded = shards is not None and shards.sharded
        whole = shards.meta(trainable) if sharded else trainable
        if sparse_embed_path is None:
            opt_state = optimizer.init(whole)
        else:
            if sparse_embed_path not in trainable:
                raise ValueError(f"sparse-embed path {sparse_embed_path} not "
                                 "found among trainable params")
            dense = {k: p for k, p in whole.items()
                     if k != sparse_embed_path}
            opt_state = {"dense": optimizer.init(dense),
                         "sparse_embed": init_sparse_embed_state(
                             whole[sparse_embed_path])}
        if sharded:
            opt_state = shards.materialize(opt_state, model_device(model))
        return cls(params=trainable, buffers=dict(model.named_buffers()),
                   opt_state=opt_state, step=0)


def make_train_step(
    strategy,
    optimizer: AdamW,
    *,
    accum_steps: int = 1,
    total_steps: Optional[int] = None,
    metadata: Optional[Dict[str, Any]] = None,
    lr_schedule: Optional[Callable] = None,
    grads_dtype: Any = "float32",
    compute_params_dtype: Optional[Any] = None,
    sparse_embed: Optional[SparseEmbedPlan] = None,
    mesh=None,
    shards: Optional[ShardPlan] = None,
) -> Callable:
    """Build ``train_step(state, batch, frozen) -> (state, metrics)``.

    ``batch``: dict of [accum, B, ...] tensors. ``frozen``: dict of
    non-trainable tensors (the target lm_head weight). ``metrics`` are 0-d
    fp32 tensors on the model's device (no host sync in the step). The
    returned function carries its parts as ``micro_step(state, tensors,
    frozen)``, ``accumulate(state, batch, frozen)`` (neither changes the
    state) and ``update(state, grads, stats)`` (the clip and the optimizer
    step, in place). On a ``mesh`` of several ranks ``shards`` is the
    model's :class:`ShardPlan`."""
    metadata = dict(metadata or {})
    grads_dtype = _dtype(grads_dtype)
    compute_params_dtype = (
        _dtype(compute_params_dtype) if compute_params_dtype is not None
        else None
    )
    model = strategy.model
    gathered = shards is not None and shards.sharded
    block = mesh.batch_block if mesh is not None else (0, 1)
    uses_loss_terms = getattr(strategy, "uses_loss_terms", False)
    embed_path = getattr(strategy, "sparse_embed_path", None)
    sparse_path = sparse_embed.path if sparse_embed is not None else None
    lookup_ids = getattr(strategy, "lookup_ids", lambda tensors: None)

    def cast(name, p):
        if (compute_params_dtype is not None and p.dtype == torch.float32
                and name != embed_path):
            return p.to(compute_params_dtype)
        return p

    def micro(state: TrainState, tensors, frozen, ctx):
        names = [n for n in state.params if n != sparse_path]
        params = None
        if gathered:
            params, leaves = shards.gather_params(
                model, cast, set(names), lookup_ids(tensors))
            targets = [leaves.get(n, state.params[n]) for n in names]
        else:
            if compute_params_dtype is not None:
                params = {name: cast(name, p)
                          for name, p in model.named_parameters()}
            targets = [state.params[n] for n in names]
        if sparse_embed is not None:
            # the table is a constant of this graph; its rows' gradient
            # arrives through embed_delta
            params = dict(params or {})
            params[sparse_path] = params.get(
                sparse_path, state.params[sparse_path]).detach()
            delta = torch.zeros(sparse_embed.delta_shape_fn(tensors),
                                dtype=torch.float32,
                                device=model_device(model), requires_grad=True)
            tensors = {**tensors, "embed_delta": delta}
            targets.append(delta)
        out = strategy.forward_loss(tensors, frozen, ctx, metadata,
                                    params=params)
        if out.loss_terms is None:
            target, denom = out.loss, torch.ones((), device=out.loss.device)
        else:
            target, denom = out.loss_terms
        grads = list(torch.autograd.grad(target, targets))
        sparse = None
        if sparse_embed is not None:
            d_delta = grads.pop()
            sparse = (out.aux["embedded_ids"].reshape(-1),
                      d_delta.reshape(-1, d_delta.shape[-1]).float())
        grads = {n: g.to(grads_dtype) for n, g in zip(names, grads)}
        stats = {
            "loss": target.detach().float(),
            "denom": denom.detach().float(),
            "metrics": {k: v.detach().float() for k, v in out.metrics.items()},
            "ratio_num": {k: v[0].detach().float()
                          for k, v in out.ratio_metrics.items()},
            "ratio_den": {k: v[1].detach().float()
                          for k, v in out.ratio_metrics.items()},
        }
        return grads, stats, sparse

    def micro_step(state: TrainState, tensors: Mapping[str, torch.Tensor],
                   frozen: Mapping[str, torch.Tensor]):
        """One micro-batch's forward and backward → (gradients in
        ``grads_dtype``, stats)."""
        ctx = StepContext(global_step=state.step, total_steps=total_steps,
                          batch_block=block)
        grads, stats, _ = micro(state, tensors, frozen, ctx)
        return grads, stats

    def accumulate(state: TrainState, batch: Mapping[str, torch.Tensor],
                   frozen: Mapping[str, torch.Tensor]):
        """The micro-steps of one window → (fp32 gradients divided by the
        window's norm, as the optimizer receives them before the clip; the
        stats summed over the micro-batches, with ``stats["norm"]`` that
        norm: the number of micro-batches, or the summed ``loss_terms``
        denominator for a strategy that ``uses_loss_terms``). On the
        row-sparse path ``stats["sparse_embed"]`` holds the touched rows'
        ids and their summed gradients, divided by the norm too. On a mesh
        the gradients are this rank's slices of their sums over all
        ranks."""
        ctx = StepContext(global_step=state.step, total_steps=total_steps,
                          batch_block=block)
        n_micro = next(iter(batch.values())).shape[0]
        grads, stats, sparse = micro(
            state, {k: v[0] for k, v in batch.items()}, frozen, ctx)
        ids, rows = ([sparse[0]], [sparse[1]]) if sparse else ([], [])
        for i in range(1, n_micro):
            g, s, sp = micro(state, {k: v[i] for k, v in batch.items()},
                             frozen, ctx)
            for name in grads:
                grads[name] = grads[name] + g[name]
            stats = _tree_add(stats, s)
            if sp is not None:
                ids.append(sp[0])
                rows.append(sp[1])
            del g
        if uses_loss_terms:
            norm = torch.clamp(stats["denom"], min=1e-6)
        else:
            norm = torch.tensor(float(n_micro), device=stats["denom"].device)
        stats["norm"] = norm
        if sparse_embed is not None:
            ids, rows = ((torch.cat(ids), torch.cat(rows)) if shards is None
                         else shards.gather_rows(ids, rows))
            stats["sparse_embed"] = segment_sum_rows(ids, rows / norm)
        if shards is not None:
            shards.reduce_grads(grads)
        # optimizer math is fp32 regardless of the grad storage dtype
        return {k: g.float() / norm for k, g in grads.items()}, stats

    def update(state: TrainState, grads, stats) -> torch.Tensor:
        """Clip and one optimizer step on ``state`` (its parameters in
        place, its ``opt_state`` replaced) → the global grad norm."""
        if sparse_embed is None:
            grad_norm = global_norm(grads, shards)
            state.opt_state = optimizer.step(state.params, grads,
                                             state.opt_state, grad_norm,
                                             shards=shards)
            return grad_norm
        uids, summed = stats["sparse_embed"]
        # clip by the global norm over the dense grads and the embedding
        # rows (whole on every rank: counted once)
        grad_norm = torch.sqrt(global_norm(grads, shards) ** 2
                               + torch.sum(summed * summed))
        max_norm = sparse_embed.opt_config.max_grad_norm
        scale = torch.where(grad_norm < max_norm, torch.ones_like(grad_norm),
                            max_norm / torch.clamp(grad_norm, min=1e-30))
        grads = {k: g * scale for k, g in grads.items()}
        dense = {k: p for k, p in state.params.items() if k != sparse_path}
        state.opt_state = {
            "dense": optimizer.step(dense, grads, state.opt_state["dense"],
                                    clip=False, shards=shards),
            "sparse_embed": sparse_embed_update(
                sparse_embed.opt_config, sparse_embed.schedule,
                state.opt_state["sparse_embed"], state.params[sparse_path],
                uids, summed * scale,
                shards.slice_of(sparse_path) if shards is not None
                else None),
        }
        return grad_norm

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   frozen: Mapping[str, torch.Tensor]):
        n_micro = next(iter(batch.values())).shape[0]
        if n_micro != accum_steps:
            raise ValueError(
                f"batch has {n_micro} micro-batches, expected {accum_steps}"
            )
        grads, stats = accumulate(state, batch, frozen)
        loss_out = stats["loss"] / stats["norm"]
        new_state = TrainState(params=state.params, buffers=state.buffers,
                               opt_state=state.opt_state, step=state.step)
        grad_norm = update(new_state, grads, stats)
        del grads
        new_state.step = state.step + 1
        metrics = {"train/loss": loss_out, "train/grad_norm": grad_norm}
        for k, v in stats["metrics"].items():
            metrics[f"train/{k}"] = v / accum_steps
        for k in stats["ratio_num"]:
            metrics[f"train/{k}"] = stats["ratio_num"][k] / torch.clamp(
                stats["ratio_den"][k], min=1e-6)
        if lr_schedule is not None:
            metrics["train/lr"] = torch.tensor(lr_schedule(state.step),
                                               dtype=torch.float32)
        return new_state, metrics

    # its parts, for callers that time a micro-step or read the gradients
    train_step.micro_step = micro_step
    train_step.accumulate = accumulate
    train_step.update = update
    return train_step


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    return a + b
