"""P-EAGLE chain-of-drafts (COD) training.

Counterpart of ``specforge_tpu/algorithms/peagle/model.py``, with its static
shapes:

- Depth 0 covers all S positions. Depth d >= 1 has a static capacity
  ``cap_d = ceil(S * max(dsr^d, dsr_min))`` and a per-slot validity mask
  carries the sampled count, so the sampled length ``T = S + sum(cap_d)`` is
  fixed by the sampler config.
- The COD predicate (same document, and the key at depth 0 and anchor-causal
  or the same rollout depth-ordered) is the [B, T, T] mask of
  :func:`peagle_allow_mask`, built once per forward; the kernel backend reads
  the sample's properties and the tile-skip table made from that mask.
- The sampler's uniform draws come from an explicit CPU
  :class:`torch.Generator` (the strategy keys it on (seed, global step)), so
  the CPU and the card draw the same sample; torch cannot replay
  ``jax.random``, so the parity tests hand the port the sample JAX drew.
- The sample is sorted into doc-major order (invalid slots last) with an
  int64 key, so that packed rows give a block-diagonal predicate whose
  cross-document tiles the kernels skip. The key keeps the JAX key's field
  order (invalid, doc, depth, position) without its bit limits (positions
  below 2^14, docs + 1 below 2^8).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from specforge_tpu_torch.models.draft.peagle import (
    PEagleDraftModel,
    cod_capacities,
)
from specforge_tpu_torch.ops.loss import log_softmax_loss
from specforge_tpu_torch.ops.masks import block_uniform
from specforge_tpu_torch.ops.peagle_attention_cuda import (
    cod_allow_dense,
    cod_tiles,
)
from specforge_tpu_torch.ops.teacher import draft_gather_indices
from specforge_tpu_torch.parallel.usp import mesh_sum, mesh_sums


def document_ids_from_lengths(lengths: torch.Tensor,
                              seq_length: int) -> torch.Tensor:
    """[..., D] (0-padded) document lengths → [..., S] per-position doc id,
    -1 past the end."""
    ends = torch.cumsum(lengths.to(torch.int64), dim=-1)
    pos = torch.arange(seq_length, device=lengths.device)
    pos = pos.expand(*ends.shape[:-1], seq_length).contiguous()
    doc = torch.searchsorted(ends.contiguous(), pos, right=True)
    return torch.where(pos < ends[..., -1:], doc,
                       torch.full_like(doc, -1)).to(torch.int32)


class CODSample(NamedTuple):
    anchor_pos: torch.Tensor  # [B, T] int32
    depth: torch.Tensor       # [B, T] int32
    valid: torch.Tensor       # [B, T] bool


def generate_cod_sample_indices(
    generator: torch.Generator,
    loss_mask: torch.Tensor,      # [B, S]
    doc_ids: torch.Tensor,        # [B, S] int32, -1 = padding
    num_depths: int,
    down_sample_ratio: float,
    down_sample_ratio_min: float,
    filter_position_zero: bool = True,
    block: Tuple[int, int] = (0, 1),
) -> CODSample:
    """The COD sample of every row, in depth-major order → fields [B, T].

    Depth 0 keeps every position; depth d draws up to ``cap_d`` targets
    uniformly from the positions whose depth-(d-1) target was kept and
    supervised, whose anchor (target - d) lies in the same document. The
    uniform values are drawn on the generator's device and moved to the
    mask's, so a CPU generator gives the same sample on every device; they
    are drawn for the global batch, one [B·n, S] draw per depth, and the
    rows of batch block ``block = (first, n)`` kept (``block_uniform``)."""
    b, s = loss_mask.shape
    uniforms = [block_uniform(generator, (b, s), block).to(loss_mask.device)
                for _ in range(1, num_depths)]
    return cod_sample_from_uniform(uniforms, loss_mask, doc_ids, num_depths,
                                   down_sample_ratio, down_sample_ratio_min,
                                   filter_position_zero)


def cod_sample_from_uniform(
    uniforms,                     # per depth 1..D-1: [B, S] in [0, 1)
    loss_mask: torch.Tensor,
    doc_ids: torch.Tensor,
    num_depths: int,
    down_sample_ratio: float,
    down_sample_ratio_min: float,
    filter_position_zero: bool = True,
) -> CODSample:
    """The sample of :func:`generate_cod_sample_indices` from its uniform
    values."""
    b, s = loss_mask.shape
    device = loss_mask.device
    caps = cod_capacities(s, num_depths, down_sample_ratio,
                          down_sample_ratio_min)
    pos = torch.arange(s, device=device).expand(b, s)
    doc_ids = doc_ids.to(torch.int64)
    all_valid = loss_mask > 0.5
    n_valid = all_valid.sum(dim=1)

    anchors = [pos.to(torch.int32)]
    depths = [torch.zeros((b, s), dtype=torch.int32, device=device)]
    valids = [torch.ones((b, s), dtype=torch.bool, device=device)]
    prev_valid = all_valid  # mask over *target* positions
    for d in range(1, num_depths):
        cap = caps[d]
        ratio = max(down_sample_ratio ** d, down_sample_ratio_min)
        cand = prev_valid & (pos >= d)
        anchors_c = torch.clamp(pos - d, min=0)
        same_doc = (doc_ids >= 0) & (doc_ids == doc_ids.gather(1, anchors_c))
        eligible = cand & same_doc
        n_eligible = eligible.sum(dim=1)
        valid_length = torch.clamp(n_valid - d, min=0)
        sample_size = torch.minimum(
            (valid_length.to(torch.float32) * ratio).to(torch.int64),
            n_eligible)
        rand = torch.where(eligible, uniforms[d - 1],
                           torch.full_like(uniforms[d - 1], 2.0))
        order = torch.argsort(rand, dim=1, stable=True)[:, :cap]
        slot_keep = (torch.arange(cap, device=device)[None, :]
                     < torch.clamp(sample_size, max=cap)[:, None])
        sel = torch.where(slot_keep, order, torch.full_like(order, s))
        sel = torch.sort(sel, dim=1).values
        keep = sel < s
        targets = torch.where(keep, sel, torch.zeros_like(sel))

        anchors.append(torch.where(keep, targets - d,
                                   torch.zeros_like(targets)).to(torch.int32))
        depths.append(torch.full((b, cap), d, dtype=torch.int32,
                                 device=device))
        valids.append(keep)

        nxt = (targets + 1) % s
        keep_next = keep & all_valid.gather(1, nxt)
        if filter_position_zero:
            keep_next = keep_next & (nxt != 0)
        prev_valid = torch.zeros((b, s), dtype=torch.int32, device=device)
        prev_valid = prev_valid.scatter_reduce(
            1, nxt, keep_next.to(torch.int32), reduce="amax") > 0

    return CODSample(
        anchor_pos=torch.cat(anchors, dim=1),
        depth=torch.cat(depths, dim=1),
        valid=torch.cat(valids, dim=1),
    )


def cod_sort_key(valid: torch.Tensor, doc: torch.Tensor, depth: torch.Tensor,
                 position: torch.Tensor) -> torch.Tensor:
    """int64 doc-major key: (invalid, doc + 1, depth, position) in bit
    fields [62], [40, 62), [32, 40), [0, 32) — the JAX key's field order,
    without its int32 bit limits."""
    i64 = torch.int64
    return (((1 - valid.to(i64)) << 62) + ((doc.to(i64) + 1) << 40)
            + (depth.to(i64) << 32) + position.to(i64))


def doc_major(sample: CODSample, doc_ids: torch.Tensor) -> CODSample:
    """The sample reordered doc-major, invalid slots last (a stable sort,
    so entries with equal keys keep their order, as in JAX)."""
    orig = (sample.anchor_pos + sample.depth).to(torch.int64)
    key = cod_sort_key(sample.valid, doc_ids.to(torch.int64).gather(1, orig),
                       sample.depth, orig)
    perm = torch.argsort(key, dim=1, stable=True)
    return CODSample(*(x.gather(1, perm) for x in sample))


def peagle_allow_mask(sample: CODSample, doc_ids: torch.Tensor) -> torch.Tensor:
    """[B, T, T] COD attention predicate, through
    :func:`~specforge_tpu_torch.ops.peagle_attention_cuda.cod_allow_dense`,
    the one Python source of the predicate the kernels evaluate."""
    return cod_allow_dense(
        sample.anchor_pos, sample.depth,
        doc_ids.to(torch.int64).gather(1, sample.anchor_pos.to(torch.int64)),
        sample.valid.to(torch.int32))


class OnlinePEagleModel(nn.Module):
    """COD training over a :class:`PEagleDraftModel`. ``loss_fn`` is the
    fused CE (the kernels on CUDA tensors, their plain versions on CPU
    ones); a caller may swap in ``log_softmax_loss_reference``."""

    def __init__(self, draft_model: PEagleDraftModel, mask_token_id: int,
                 num_depths: int = 8, down_sample_ratio: float = 0.7,
                 down_sample_ratio_min: float = 0.2):
        super().__init__()
        self.draft_model = draft_model
        self.mask_token_id = int(mask_token_id)
        self.num_depths = num_depths
        self.down_sample_ratio = down_sample_ratio
        self.down_sample_ratio_min = down_sample_ratio_min
        self.loss_fn = log_softmax_loss
        #: the rank grid whose ranks hold the rest of the global batch: the
        #: loss's denominator and the metric sums are summed over it
        self.mesh = None

    def sampled_length(self, seq_length: int) -> int:
        return sum(cod_capacities(seq_length, self.num_depths,
                                  self.down_sample_ratio,
                                  self.down_sample_ratio_min))

    def forward(
        self,
        input_ids: torch.Tensor,       # [B, S]
        attention_mask: torch.Tensor,  # [B, S]
        target: torch.Tensor,          # [B, S, V] teacher logits
        loss_mask: torch.Tensor,       # [B, S] or [B, S, 1]
        hidden_states: torch.Tensor,   # [B, S, 3*target_hidden]
        sample: CODSample,
        lengths: Optional[torch.Tensor] = None,
        embed_delta: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """→ (loss, metrics). ``sample`` is the step's COD sample
        (depth-major fields [B, T], as :func:`generate_cod_sample_indices`
        gives them; the strategy draws it, the parity tests hand in JAX's);
        ``embed_delta`` [B, T, H] is added to the sampled embeddings (zeros
        whose gradient is the per-position embedding gradient: the
        row-sparse update's path)."""
        b, s = input_ids.shape
        device = input_ids.device
        if loss_mask.dim() == 3:
            loss_mask = loss_mask[..., 0]
        if lengths is None:
            lengths = attention_mask.sum(dim=-1)[:, None]
        doc_ids = document_ids_from_lengths(lengths.reshape(b, -1), s)
        sample = doc_major(CODSample(*(x.to(device) for x in sample)),
                           doc_ids)
        orig = (sample.anchor_pos + sample.depth).to(torch.int64)  # [B, T]
        is_depth0 = sample.depth == 0
        rows = torch.arange(b, device=device)[:, None]

        # sampled token ids: the real token at depth 0, the mask token else
        sampled_ids = torch.where(
            is_depth0, input_ids.to(torch.int64).gather(1, orig),
            torch.full_like(orig, self.mask_token_id))
        draft = self.draft_model
        inputs_embeds = draft.embed_input_ids(sampled_ids)
        if embed_delta is not None:
            inputs_embeds = inputs_embeds + embed_delta.to(inputs_embeds.dtype)

        # sampled features: target hidden at depth 0, the learned mask
        # vector else
        gathered = hidden_states[rows, orig]
        mask_hidden = draft.mask_hidden[0, 0].to(gathered.dtype)
        sampled_hidden = torch.where(is_depth0[..., None], gathered,
                                     mask_hidden)
        sampled_hidden = draft.project_hidden_states(sampled_hidden)

        # the mask once per forward; the kernels' inputs from it
        allow = peagle_allow_mask(sample, doc_ids)             # [B, T, T]
        tiles = None
        if draft.attention_backend != "dense":
            anchor_doc = doc_ids.to(torch.int64).gather(
                1, sample.anchor_pos.to(torch.int64))
            tiles = cod_tiles(sample.anchor_pos, sample.depth, anchor_doc,
                              sample.valid, allow)
            allow = None
        h = draft.backbone(inputs_embeds, sampled_hidden, allow, orig, tiles)
        logits = draft.compute_logits(h)

        loss, metrics = self._loss_and_metrics(logits, target, loss_mask,
                                               sample, orig)
        # int row ids of the embedded tokens (for the row-sparse update);
        # the strategy strips this from the logged metrics
        metrics["embedded_ids"] = sampled_ids.reshape(-1)
        return loss, metrics

    def _loss_and_metrics(self, logits, target, loss_mask, sample, orig):
        draft = self.draft_model
        b = logits.shape[0]
        rows = torch.arange(b, device=logits.device)[:, None]
        sampled_loss_mask = (loss_mask.gather(1, orig).float()
                             * sample.valid.float())               # [B, T]
        target_top1 = target.argmax(dim=-1)                         # [B, S]
        in_draft = draft.t2d[target_top1.gather(1, orig)]
        sampled_loss_mask = sampled_loss_mask * in_draft.float()

        # gather the draft-vocab columns before expanding rows to the
        # sampled positions: the other order makes a [B, T, V] intermediate
        gather_idx = draft_gather_indices(draft.d2t)
        target_logits = target.index_select(-1, gather_idx)[rows, orig]
        target_p = torch.softmax(target_logits.float(), dim=-1).detach()
        position_mask = sampled_loss_mask[..., None]
        total_positions = position_mask.shape[0] * position_mask.shape[1]
        # one masked mean over the whole (global) batch: supervised
        # positions pool across rows (the denominator-weighted mean of
        # per-row losses); on a mesh each rank's term is its share
        denominator = torch.clamp(mesh_sum(sampled_loss_mask.sum(),
                                           self.mesh), min=1e-6)
        loss = mesh_sum(self.loss_fn(logits, target_p, position_mask) * (
            total_positions / denominator), self.mesh)

        pred_ids = logits.argmax(dim=-1)
        target_ids = target_p.argmax(dim=-1)
        metrics: Dict[str, Any] = {
            "loss_sum": loss.detach(),
            "loss_total": torch.ones((), device=logits.device),
        }
        supervised = sampled_loss_mask > 0.5
        hits = pred_ids == target_ids
        correct_total = torch.zeros((), device=logits.device)
        count_total = torch.zeros((), device=logits.device)
        for d in range(self.num_depths):
            depth_mask = (sample.depth == d) & supervised
            d_correct = (hits & depth_mask).float().sum()
            d_total = depth_mask.float().sum()
            metrics[f"position_{d}_acc_sum"] = d_correct
            metrics[f"position_{d}_acc_total"] = d_total
            correct_total = correct_total + d_correct
            count_total = count_total + d_total
        metrics["full_acc_sum"] = correct_total
        metrics["full_acc_total"] = count_total
        sums = [k for k in metrics if k.startswith(("position_", "full_"))]
        metrics.update(zip(sums, mesh_sums([metrics[k] for k in sums],
                                           self.mesh)))
        return loss, metrics
