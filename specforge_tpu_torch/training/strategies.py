"""Training strategies: TrainBatch tensors → loss + metrics.

Counterpart of ``specforge_tpu/training/strategies.py`` (``StepOutput``,
``linear_lambda_base`` and the EAGLE3, DFlash, Domino, DSpark and P-EAGLE
strategies). The JAX strategy receives its parameters explicitly; here the
strategy holds the training model, whose parameters live on its device, and
moves each batch there. ``forward_loss`` may be handed substitute tensors for the model's
parameters (the train step's once-per-micro-step cast copies), which it
applies through ``torch.func.functional_call``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from specforge_tpu_torch.algorithms.peagle.model import (
    document_ids_from_lengths,
    generate_cod_sample_indices,
)
from specforge_tpu_torch.data.collator import (
    position_ids_from_seq_second,
    position_ids_seq_second,
)
from specforge_tpu_torch.models.target.head import (
    apply_target_head,
    target_head_preprocess,
)
from specforge_tpu_torch.ops.masks import sample_anchor_positions
from specforge_tpu_torch.parallel.usp import SequenceShard
from specforge_tpu_torch.utils import model_device, to_device


@dataclass
class StepOutput:
    """loss keeps grad; metrics are detached scalars; ratio_metrics are
    (numerator, denominator) pairs summed across batches before dividing;
    loss_terms optionally carries an additive objective (numerator,
    denominator) whose denominator the train step sums over the window (the
    DFlash-family contract)."""

    loss: torch.Tensor
    metrics: Dict[str, torch.Tensor] = field(default_factory=dict)
    ratio_metrics: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict
    )
    loss_terms: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    #: non-logged passthrough tensors the train step may consume (the
    #: embedded-token row ids of the row-sparse embedding update)
    aux: Dict[str, torch.Tensor] = field(default_factory=dict)


@dataclass(frozen=True)
class StepContext:
    global_step: Any = 0
    total_steps: Optional[int] = None
    #: (this rank's batch block, the number of blocks): a sampler draws for
    #: the global batch and keeps the block's rows
    batch_block: Tuple[int, int] = (0, 1)


def linear_lambda_base(global_step, total_steps: int,
                       lambda_start: float = 1.0,
                       decay_ratio: float = 0.5) -> float:
    """Domino base-loss weight: linear decay to 0 over
    ``total_steps * decay_ratio`` steps, in float32 as the JAX package
    computes it."""
    f32 = np.float32
    decay_steps = max(1, int(total_steps * decay_ratio))
    progress = min(f32(int(global_step)) / f32(decay_steps), f32(1.0))
    return float(np.clip(f32(lambda_start) * (f32(1.0) - progress),
                         f32(0.0), f32(1.0)))


def _validate_batch(strategy, tensors: Dict[str, Any]) -> None:
    missing = {f for f in strategy.required_features if f not in tensors}
    if missing:
        raise ValueError(
            f"{strategy.name} batch missing required features "
            f"{sorted(missing)}; present={sorted(tensors)}"
        )


def _step_generator(seed: int, ctx: Optional["StepContext"]) -> torch.Generator:
    """A CPU generator keyed on (seed, global step): resumes and every
    device draw the same samples."""
    step = ctx.global_step if ctx is not None else 0
    key = ((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF)
    return torch.Generator().manual_seed(key)


def _batch_block(ctx: Optional["StepContext"]) -> Tuple[int, int]:
    return ctx.batch_block if ctx is not None else (0, 1)


def _take(shard: SequenceShard, name: str, x: torch.Tensor,
          lookahead: int = 0) -> torch.Tensor:
    """``shard.take`` over the sequence axis (for position ids, as
    :func:`position_ids_seq_second` puts it)."""
    if name == "position_ids":
        return position_ids_from_seq_second(
            shard.take(position_ids_seq_second(x), lookahead))
    return shard.take(x, lookahead)


def _apply(model, params, args, kwargs):
    if params is None:
        return model(*args, **kwargs)
    return torch.func.functional_call(model, params, args, kwargs)


class Eagle3TrainStrategy:
    """EAGLE3 TTT strategy over :class:`OnlineEagle3Model`.

    ``target_repr``:
      - "hidden_state" (offline): re-run the frozen head over the stored last
        hidden state — or stream it in vocab chunks when ``compact_teacher``.
      - "logits"/None (online): use delivered teacher logits as they are.

    Under the ``"usp"`` backend every rank of the sequence group holds the
    same global batch on the host and moves only its own cut to the card
    (``SequenceShard.take``: its chunk, the halo after it, and one position
    more for the teacher shift, which runs after the cut).
    """

    name = "eagle3"
    required_features = {
        "input_ids", "attention_mask", "loss_mask", "hidden_state", "target",
    }
    #: the batch's [B, S, ...] tensors, cut to this rank's positions
    positional = required_features | {"position_ids"}
    #: those the teacher shift moves one position left
    shifted = {"input_ids", "target"}

    def __init__(
        self,
        model,
        *,
        ploss_decay: float = 0.8,
        compact_teacher: bool = False,
        compact_teacher_chunk_size: int = 32768,
    ) -> None:
        self.model = model
        self.ploss_decay = ploss_decay
        self.compact_teacher = compact_teacher
        self.compact_teacher_chunk_size = compact_teacher_chunk_size

    def lookup_ids(self, tensors) -> Dict[str, torch.Tensor]:
        """The rows of the draft's embedding a micro-batch can look up: its
        ids, and 0, which the shifts pad with."""
        ids = tensors["input_ids"].reshape(-1)
        return {"draft_model.embed_tokens.weight":
                torch.cat([ids, ids.new_zeros(1)])}

    def _shard(self, seq_len: int) -> SequenceShard:
        draft = self.model.draft_model
        mesh = draft.mesh if draft.attention_backend == "usp" else None
        return SequenceShard.of(mesh, seq_len, self.model.length - 1)

    def _inputs(self, tensors, frozen, metadata, compact: bool):
        """This rank's cut of the batch, device placement, the teacher
        shift and the model's arguments."""
        _validate_batch(self, tensors)
        shift = (metadata or {}).get("target_repr") == "hidden_state"
        shard = self._shard(tensors["input_ids"].shape[1])
        tensors = {k: _take(shard, k, v, int(shift and k in self.shifted))
                   if k in self.positional else v
                   for k, v in tensors.items()}
        device = model_device(self.model)
        tensors = to_device(tensors, device)
        frozen = to_device(frozen, device)
        input_ids = tensors["input_ids"]
        target = tensors["target"]
        loss_mask = tensors["loss_mask"]
        kwargs: Dict[str, Any] = {"shard": shard}
        if shift:
            head_w = frozen.get("target_head_weight")
            if head_w is None:
                raise ValueError(
                    "target_repr='hidden_state' requires "
                    "frozen['target_head_weight']"
                )
            input_ids, target_hidden, loss_mask = target_head_preprocess(
                input_ids, target, loss_mask
            )
            # the shift read the one position past the cut; drop it
            input_ids, target_hidden = (shard.trim(input_ids),
                                        shard.trim(target_hidden))
            if compact:
                target = None
                kwargs.update(
                    target_hidden_for_compact=target_hidden,
                    target_head_weight=head_w,
                    compact_teacher_chunk_size=self.compact_teacher_chunk_size,
                )
            else:
                target = apply_target_head(head_w, target_hidden)
        elif loss_mask.dim() == 2:
            loss_mask = loss_mask[..., None]
        return (
            input_ids, tensors["attention_mask"], loss_mask,
            tensors["hidden_state"], target,
        ), dict(position_ids=tensors.get("position_ids"), **kwargs)

    def forward_loss(
        self,
        tensors: Dict[str, torch.Tensor],
        frozen: Dict[str, torch.Tensor],
        ctx: Optional[StepContext] = None,
        metadata: Optional[Dict[str, Any]] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> StepOutput:
        args, kwargs = self._inputs(tensors, frozen, metadata,
                                    self.compact_teacher)
        out = _apply(self.model, params, args, kwargs)
        length = out.plosses.shape[0]
        weights = torch.tensor(
            [self.ploss_decay ** i for i in range(length)],
            dtype=torch.float32, device=out.plosses.device,
        )
        loss = torch.sum(weights * out.plosses)
        ratio_metrics = {}
        for i in range(length):
            ratio_metrics[f"acc_{i}"] = (
                out.metric_corrects[i], out.metric_denoms[i]
            )
            ratio_metrics[f"ploss_{i}"] = (
                out.metric_losses[i] * out.metric_loss_denoms[i],
                out.metric_loss_denoms[i],
            )
        metrics = {
            f"acceptance_rate_{i}": out.acceptance_rates[i] for i in range(length)
        }
        return StepOutput(loss=loss, metrics=metrics, ratio_metrics=ratio_metrics)

    def eval_outputs(
        self,
        tensors: Dict[str, torch.Tensor],
        frozen: Dict[str, torch.Tensor],
        metadata: Optional[Dict[str, Any]] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        """Batch-size-invariant eval sums: per-TTT-position numerators and
        denominators, divided only after reduction over the eval set (on a
        mesh the model sums them over the ranks: the global batch's). The
        eval pass uses the full-vocab head, as the JAX strategy does."""
        args, kwargs = self._inputs(tensors, frozen, metadata, compact=False)
        out = _apply(self.model, params, args, kwargs)
        return {
            "corrects": out.metric_corrects,
            "denoms": out.metric_denoms,
            "acc_nums": out.acceptance_nums,
            "acc_dens": out.acceptance_denoms,
            "loss_sums": out.metric_losses * out.metric_loss_denoms,
            "loss_dens": out.metric_loss_denoms,
        }


class DFlashTrainStrategy:
    """DFlash block-parallel strategy over :class:`OnlineDFlashModel`.

    Anchors are sampled here, from a CPU ``torch.Generator`` keyed on
    (seed, global step), so resumes and the kernel and plain attention paths
    draw the same anchors on any device. The loss is normalised through
    ``loss_terms`` over the whole accumulation window. The JAX strategies of
    the family define no eval pass."""

    name = "dflash"
    required_features = {"input_ids", "hidden_states", "loss_mask"}
    uses_loss_terms = True
    #: batch features the model takes after the generator (DSpark's teacher)
    model_features: Tuple[str, ...] = ()

    def __init__(self, model, *, seed: int = 0) -> None:
        self.model = model
        self.seed = seed

    def sample_anchors(self, loss_mask: torch.Tensor,
                       ctx: Optional[StepContext]):
        """(positions [B, N] int32, keep [B, N] bool) for this step."""
        return sample_anchor_positions(
            _step_generator(self.seed, ctx), loss_mask,
            self.model.num_anchors, _batch_block(ctx))

    def _run(self, tensors, frozen, ctx, params, *extra):
        _validate_batch(self, tensors)
        device = model_device(self.model)
        tensors = to_device(tensors, device)
        frozen = to_device(frozen, device)
        loss_mask = tensors["loss_mask"]
        if loss_mask.dim() == 3:
            loss_mask = loss_mask[..., 0]
        args = (tensors["input_ids"], tensors["hidden_states"], loss_mask,
                frozen["target_head_weight"], frozen["target_embed_weight"],
                None, *[tensors[k] for k in self.model_features], *extra)
        kwargs = {"anchors": self.sample_anchors(loss_mask, ctx)}
        return _apply(self.model, params, args, kwargs)

    def forward_loss(
        self,
        tensors: Dict[str, torch.Tensor],
        frozen: Dict[str, torch.Tensor],
        ctx: Optional[StepContext] = None,
        metadata: Optional[Dict[str, Any]] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> StepOutput:
        loss, accuracy, model_metrics = self._run(tensors, frozen, ctx, params)
        return StepOutput(
            loss=loss,
            metrics={"accuracy": accuracy.detach()},
            ratio_metrics=model_metrics.get("ratio_metrics", {}),
            loss_terms=model_metrics.get("loss_terms"),
        )


class DominoTrainStrategy(DFlashTrainStrategy):
    """Domino strategy: the DFlash spine with a decaying base-loss blend
    (``lambda_base`` from the step context's global and total steps)."""

    name = "domino"
    uses_loss_terms = False

    def __init__(self, model, *, seed: int = 0, lambda_start: float = 1.0,
                 decay_ratio: float = 0.5) -> None:
        super().__init__(model, seed=seed)
        self.lambda_start = lambda_start
        self.decay_ratio = decay_ratio

    def lambda_base(self, ctx: Optional[StepContext]) -> float:
        if ctx is None or not ctx.total_steps:
            return 0.0
        return linear_lambda_base(ctx.global_step, ctx.total_steps,
                                  self.lambda_start, self.decay_ratio)

    def forward_loss(self, tensors, frozen, ctx=None, metadata=None,
                     params=None) -> StepOutput:
        loss, accuracy, model_metrics = self._run(
            tensors, frozen, ctx, params, self.lambda_base(ctx))
        metrics = {k: v.detach() for k, v in model_metrics.items()}
        metrics["accuracy"] = accuracy.detach()
        return StepOutput(loss=loss, metrics=metrics)


class DSparkTrainStrategy(DFlashTrainStrategy):
    """DSpark strategy: the DFlash spine with the target's last hidden
    state as the teacher (its L1 and confidence terms), passed as the
    model's last argument. The loss is token-pooled in the model; there
    are no ``loss_terms``."""

    name = "dspark"
    required_features = {"input_ids", "hidden_states", "loss_mask",
                         "target_last_hidden_states"}
    uses_loss_terms = False
    model_features = ("target_last_hidden_states",)


class PEagleTrainStrategy:
    """P-EAGLE COD strategy over :class:`OnlinePEagleModel`.

    Consumes the EAGLE3 capture (``hidden_state`` + ``target``); the COD
    sample is drawn from a CPU generator keyed on (seed, global step).
    Unlike EAGLE3, the embeddings and ``mask_hidden`` train, so the whole
    draft is checkpointed (the trainer saves every trainable parameter)."""

    name = "peagle"
    required_features = {
        "input_ids", "attention_mask", "loss_mask", "hidden_state", "target",
    }
    #: COD reads per-document ``lengths``: packed rows are supported
    #: (``PackingCollator``; ``data.pack_documents``)
    supports_packed_documents = True
    #: name of the trainable embedding table among the model's parameters
    sparse_embed_path = "draft_model.embed_tokens.weight"

    def __init__(self, model, *, seed: int = 0) -> None:
        self.model = model
        self.seed = seed

    def lookup_ids(self, tensors) -> Dict[str, torch.Tensor]:
        """The rows of the embedding a micro-batch can look up: its ids, 0
        (the teacher shift's pad) and the mask token."""
        ids = tensors["input_ids"].reshape(-1)
        return {self.sparse_embed_path: torch.cat(
            [ids, ids.new_tensor([0, self.model.mask_token_id])])}

    def sparse_embed_delta_shape(self, tensors) -> Tuple[int, int, int]:
        """[B, T_sampled, H] shape of the zeros whose gradient is the
        per-position embedding gradient (T is fixed by the sampler)."""
        b, s = tensors["input_ids"].shape[:2]
        return (b, self.model.sampled_length(s),
                self.model.draft_model.config.hidden_size)

    def draw_sample(self, loss_mask: torch.Tensor, lengths: torch.Tensor,
                    ctx: Optional[StepContext]):
        """This step's COD sample (depth-major fields [B, T]) of the shifted
        [B, S, 1] loss mask and the per-row document lengths."""
        b, s = loss_mask.shape[:2]
        model = self.model
        return generate_cod_sample_indices(
            _step_generator(self.seed, ctx), loss_mask.reshape(b, s),
            document_ids_from_lengths(lengths.reshape(b, -1), s),
            model.num_depths, model.down_sample_ratio,
            model.down_sample_ratio_min, block=_batch_block(ctx))

    def forward_loss(
        self,
        tensors: Dict[str, torch.Tensor],
        frozen: Dict[str, torch.Tensor],
        ctx: Optional[StepContext] = None,
        metadata: Optional[Dict[str, Any]] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> StepOutput:
        _validate_batch(self, tensors)
        device = model_device(self.model)
        tensors = to_device(tensors, device)
        frozen = to_device(frozen, device)
        input_ids = tensors["input_ids"]
        target = tensors["target"]
        loss_mask = tensors["loss_mask"]
        if (metadata or {}).get("target_repr") == "hidden_state":
            input_ids, target_hidden, loss_mask = target_head_preprocess(
                input_ids, target, loss_mask)
            target = apply_target_head(frozen["target_head_weight"],
                                       target_hidden)
        lengths = tensors.get("lengths")
        if lengths is None:
            lengths = tensors["attention_mask"].sum(dim=-1)
        args = (input_ids, tensors["attention_mask"], target, loss_mask,
                tensors["hidden_state"],
                self.draw_sample(loss_mask, lengths, ctx), lengths,
                tensors.get("embed_delta"))
        loss, model_metrics = _apply(self.model, params, args, {})
        metrics = {k: v.detach() for k, v in model_metrics.items()
                   if k.endswith(("_sum", "_total"))}
        ratio_metrics = {"accuracy": (model_metrics["full_acc_sum"],
                                      model_metrics["full_acc_total"])}
        return StepOutput(
            loss=loss.reshape(()), metrics=metrics,
            ratio_metrics=ratio_metrics,
            aux={"embedded_ids": model_metrics["embedded_ids"].detach()},
        )
