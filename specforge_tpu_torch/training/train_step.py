"""The train step: micro-step accumulation, then one optimizer update.

Counterpart of ``specforge_tpu/training/train_step.py`` without ``jit``:
PyTorch runs eagerly, so the micro-steps are a Python loop and the
optimizer step is explicit.

- The batch carries a leading micro-step axis ``[accum, per_micro_batch,
  ...]`` (``accum=1`` for single-micro steps), as in the JAX package.
- Each micro-step's gradients come from ``torch.autograd.grad`` on the
  trainable fp32 masters, are stored in ``grads_dtype`` and summed in it;
  the optimizer math runs in fp32 after a division by ``accum_steps``
  (EAGLE3 declares no ``loss_terms``).
- Ratio metrics accumulate as (numerator, denominator) pairs and divide once.
- ``compute_params_dtype`` casts the fp32 masters to that dtype once per
  micro-step (``torch.func.functional_call`` over the cast copies) instead
  of at every use; autograd then keeps one low-precision copy of each weight
  instead of one per TTT step, and the weight gradients are summed in that
  dtype over the steps before the fp32 convert-back, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from specforge_tpu_torch.training.optimizer import AdamW, global_norm, split_trainable
from specforge_tpu_torch.training.strategies import StepContext


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
               trainable_mask: Optional[Mapping[str, bool]] = None
               ) -> "TrainState":
        trainable, _frozen = split_trainable(model, trainable_mask)
        return cls(params=trainable, buffers=dict(model.named_buffers()),
                   opt_state=optimizer.init(trainable), step=0)


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
) -> Callable:
    """Build ``train_step(state, batch, frozen) -> (state, metrics)``.

    ``batch``: dict of [accum, B, ...] tensors. ``frozen``: dict of
    non-trainable tensors (the target lm_head weight). ``metrics`` are 0-d
    fp32 tensors on the model's device (no host sync in the step). The
    returned function carries its parts as ``micro_step(state, tensors,
    frozen)`` and ``accumulate(state, batch, frozen)``; neither changes the
    state."""
    metadata = dict(metadata or {})
    grads_dtype = _dtype(grads_dtype)
    compute_params_dtype = (
        _dtype(compute_params_dtype) if compute_params_dtype is not None
        else None
    )
    model = strategy.model

    def micro(state: TrainState, tensors, frozen, ctx):
        params = None
        if compute_params_dtype is not None:
            params = {
                name: p.to(compute_params_dtype)
                if p.dtype == torch.float32 else p
                for name, p in model.named_parameters()
            }
        out = strategy.forward_loss(tensors, frozen, ctx, metadata,
                                    params=params)
        names = list(state.params)
        grads = torch.autograd.grad(out.loss, [state.params[n] for n in names])
        grads = {n: g.to(grads_dtype) for n, g in zip(names, grads)}
        stats = {
            "loss": out.loss.detach().float(),
            "metrics": {k: v.detach().float() for k, v in out.metrics.items()},
            "ratio_num": {k: v[0].detach().float()
                          for k, v in out.ratio_metrics.items()},
            "ratio_den": {k: v[1].detach().float()
                          for k, v in out.ratio_metrics.items()},
        }
        return grads, stats

    def micro_step(state: TrainState, tensors: Mapping[str, torch.Tensor],
                   frozen: Mapping[str, torch.Tensor]):
        """One micro-batch's forward and backward → (gradients in
        ``grads_dtype``, stats)."""
        ctx = StepContext(global_step=state.step, total_steps=total_steps)
        return micro(state, tensors, frozen, ctx)

    def accumulate(state: TrainState, batch: Mapping[str, torch.Tensor],
                   frozen: Mapping[str, torch.Tensor]):
        """The micro-steps of one window → (fp32 gradients divided by the
        number of micro-batches, as the optimizer receives them before the
        clip; the stats summed over the micro-batches)."""
        n_micro = next(iter(batch.values())).shape[0]
        grads, stats = micro_step(state, {k: v[0] for k, v in batch.items()},
                                  frozen)
        for i in range(1, n_micro):
            g, s = micro_step(state, {k: v[i] for k, v in batch.items()},
                              frozen)
            for name in grads:
                grads[name] = grads[name] + g[name]
            stats = _tree_add(stats, s)
            del g
        # optimizer math is fp32 regardless of the grad storage dtype
        return {k: g.float() / n_micro for k, g in grads.items()}, stats

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   frozen: Mapping[str, torch.Tensor]):
        n_micro = next(iter(batch.values())).shape[0]
        if n_micro != accum_steps:
            raise ValueError(
                f"batch has {n_micro} micro-batches, expected {accum_steps}"
            )
        grads, stats = accumulate(state, batch, frozen)
        loss_out = stats["loss"] / float(accum_steps)
        grad_norm = global_norm(grads)
        opt_state = optimizer.step(state.params, grads, state.opt_state,
                                   grad_norm)
        del grads
        metrics = {"train/loss": loss_out, "train/grad_norm": grad_norm}
        for k, v in stats["metrics"].items():
            metrics[f"train/{k}"] = v / accum_steps
        for k in stats["ratio_num"]:
            metrics[f"train/{k}"] = stats["ratio_num"][k] / torch.clamp(
                stats["ratio_den"][k], min=1e-6)
        if lr_schedule is not None:
            metrics["train/lr"] = torch.tensor(lr_schedule(state.step),
                                               dtype=torch.float32)
        new_state = TrainState(params=state.params, buffers=state.buffers,
                               opt_state=opt_state, step=state.step + 1)
        return new_state, metrics

    # its parts, for callers that time a micro-step or read the gradients
    train_step.micro_step = micro_step
    train_step.accumulate = accumulate
    return train_step


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


def _tree_add(a, b):
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    return a + b
