"""DFlash-family anchor sampling and attention masks.

Counterpart of ``specforge_tpu/ops/masks.py``:

- anchors are positions whose clean token *and* next token are supervised;
  ``num_anchors`` slots per row, the kept anchors a sorted prefix, the other
  slots 0 with keep False;
- draft query block b (at anchor a_b) sees the context keys before a_b
  (optionally bounded below by a sliding window) and its own block's draft
  keys (intra-block causal under a sliding window).

The JAX sampler draws from ``jax.random``, which torch cannot replay: here
the random values come from an explicit :class:`torch.Generator` (the
strategies key it on (seed, step)), and the parity tests feed the anchors
JAX sampled (or JAX's uniform values, :func:`anchors_from_uniform`) into
the port instead. The values are drawn for the global batch and each rank
keeps its block's rows (:func:`block_uniform`), so a run on a mesh samples
what one process samples for the same global batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def block_uniform(generator: torch.Generator, shape: Tuple[int, ...],
                  block: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Uniform values of one batch block's rows: ``shape[0] · n`` rows are
    drawn for the ``n`` blocks of the global batch and block ``first``'s
    ``shape[0]`` rows kept, ``block = (first, n)``; on the generator's
    device."""
    b = shape[0]
    first, n = block
    rand = torch.rand((b * n,) + tuple(shape[1:]), generator=generator,
                      device=generator.device)
    return rand[first * b:(first + 1) * b]


def sample_anchor_positions(
    generator: torch.Generator,
    loss_mask: torch.Tensor,
    num_anchors: int,
    block: Tuple[int, int] = (0, 1),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``num_anchors`` anchors per row from the positions s where both
    ``loss_mask[s]`` and ``loss_mask[s+1]`` are set.

    ``loss_mask``: [B, S] (or [B, S, 1]), the rows of batch block ``block``
    (:func:`block_uniform`). The uniform values are drawn on the
    generator's device and moved to the mask's, so a CPU generator gives
    the same anchors on every device.

    Returns (anchor_positions [B, N] int32 sorted ascending with the slots
    not kept 0, keep_mask [B, N] bool)."""
    if loss_mask.dim() == 3:
        loss_mask = loss_mask[..., 0]
    b, s = loss_mask.shape
    rand = block_uniform(generator, (b, max(s - 1, 0)), block)
    return anchors_from_uniform(rand.to(loss_mask.device), loss_mask,
                                num_anchors)


def anchors_from_uniform(rand: torch.Tensor, loss_mask: torch.Tensor,
                         num_anchors: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The anchors of :func:`sample_anchor_positions` from its uniform
    values ``rand`` [B, S - 1]."""
    if loss_mask.dim() == 3:
        loss_mask = loss_mask[..., 0]
    b, s = loss_mask.shape
    num_candidates = max(s - 1, 0)
    valid = (loss_mask[:, :num_candidates] > 0.5) & (
        loss_mask[:, 1:num_candidates + 1] > 0.5
    )
    counts = valid.sum(dim=1)
    rand = torch.where(valid, rand, torch.full_like(rand, 2.0))
    order = torch.argsort(rand, dim=1)[:, :num_anchors].to(torch.int32)
    if order.shape[1] < num_anchors:  # fewer candidates than slots
        order = torch.nn.functional.pad(
            order, (0, num_anchors - order.shape[1]), value=num_candidates)
    slots = torch.arange(num_anchors, device=loss_mask.device)
    keep = slots[None, :] < torch.clamp(counts, max=num_anchors)[:, None]
    sentinel = torch.full_like(order, num_candidates)
    anchors = torch.where(keep, order, sentinel).sort(dim=1).values
    keep = anchors < num_candidates
    return torch.where(keep, anchors, torch.zeros_like(anchors)), keep


def dflash_dense_mask(
    anchor_positions: torch.Tensor,
    block_keep_mask: torch.Tensor,
    seq_len: int,
    block_size: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Dense boolean allow-mask [B, 1, N*block, S + N*block] (the tests'
    oracle and the library yardstick's mask)."""
    b, n = anchor_positions.shape
    device = anchor_positions.device
    q_len = n * block_size
    q_idx = torch.arange(q_len, device=device).view(1, 1, q_len, 1)
    kv_idx = torch.arange(seq_len + q_len, device=device).view(1, 1, 1, -1)
    q_block = q_idx // block_size
    q_off = q_idx % block_size
    anchor_exp = anchor_positions.repeat_interleave(block_size, dim=1).view(
        b, 1, q_len, 1)

    mask_context = (kv_idx < seq_len) & (kv_idx < anchor_exp)
    if sliding_window is not None:
        lower = anchor_exp + q_off - (sliding_window - 1)
        mask_context = mask_context & (kv_idx >= lower)
    is_draft = kv_idx >= seq_len
    kv_block = torch.div(kv_idx - seq_len, block_size, rounding_mode="floor")
    mask_draft = is_draft & (q_block == kv_block)
    if sliding_window is not None:
        kv_off = (kv_idx - seq_len) % block_size
        mask_draft = mask_draft & (kv_off <= q_off)
    valid_block = block_keep_mask.repeat_interleave(block_size, dim=1).view(
        b, 1, q_len, 1)
    return (mask_context | mask_draft) & valid_block


def dflash_chunk_mask(
    anchor_chunk: torch.Tensor,
    keep_chunk: torch.Tensor,
    seq_len: int,
    block_size: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Allow-mask of one anchor chunk: [B, cg*block, S + cg*block], keys
    laid out as the full context [0, S) then the chunk's own draft keys."""
    b, cg = anchor_chunk.shape
    device = anchor_chunk.device
    q_len = cg * block_size
    q_off = torch.arange(block_size, device=device).repeat(cg)  # [q_len]
    anchor_q = anchor_chunk.repeat_interleave(block_size, dim=1)  # [B, q_len]
    keep_q = keep_chunk.repeat_interleave(block_size, dim=1)

    ctx_idx = torch.arange(seq_len, device=device)
    mask_context = ctx_idx[None, None, :] < anchor_q[:, :, None]
    if sliding_window is not None:
        lower = anchor_q[:, :, None] + q_off[None, :, None] - (
            sliding_window - 1)
        mask_context = mask_context & (ctx_idx[None, None, :] >= lower)

    q_block = torch.arange(cg, device=device).repeat_interleave(block_size)
    same_block = q_block[:, None] == q_block[None, :]  # [q_len, q_len]
    if sliding_window is not None:
        same_block = same_block & (q_off[None, :] <= q_off[:, None])
    mask_draft = same_block[None].expand(b, q_len, q_len)
    allow = torch.cat([mask_context, mask_draft], dim=-1)
    return allow & keep_q[:, :, None].bool()
