"""TTT branch attention (the ``"dense"`` backend: dense, or chunked over
queries for long sequences), the causal bias, and the DFlash family's
chunked block attention (the ``"chunked"`` backend).

Counterpart of ``specforge_tpu/ops/attention.py``. At TTT step ``t`` the
query attends (a) fully causally to the step-0 keys/values and (b) to exactly
one key per earlier TTT branch — the key at its own position — with all
logits normalized by one joint softmax. GQA is handled by grouped einsums
over [B, KVH, G, S, D], without repeating the keys.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from specforge_tpu_torch.ops.masks import dflash_chunk_mask

NEG_INF = -1e38  # large-negative additive bias (finite: avoids NaN rows)


def make_causal_bias(
    attention_mask: Optional[torch.Tensor],
    batch_size: int,
    seq_len: int,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Additive [B, 1, S, S] bias combining causality and key padding.

    ``attention_mask``: [B, S] with 1 = real token, 0 = padding (or None).
    """
    if attention_mask is not None:
        device = attention_mask.device
    idx = torch.arange(seq_len, device=device)
    causal = torch.where(
        idx[None, :] <= idx[:, None],
        torch.zeros((), dtype=dtype, device=device),
        torch.full((), NEG_INF, dtype=dtype, device=device),
    )
    bias = causal[None, None].expand(batch_size, 1, seq_len, seq_len)
    if attention_mask is not None:
        key_ok = attention_mask.bool()[:, None, None, :]
        bias = torch.where(key_ok, bias, torch.full((), NEG_INF, dtype=dtype,
                                                    device=device))
    return bias


def ttt_branch_attention_reference(
    q: torch.Tensor,
    keys: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    bias: torch.Tensor,
) -> torch.Tensor:
    """Dense TTT branch attention.

    Args:
        q: [B, H, Sq, D] roped queries of the current step (Sq = S, or a
            chunk of the queries).
        keys/values: branch 0 is the full causal block [B, KVH, S, D];
            branches 1..t contribute one diagonal key each, [B, KVH, Sq, D]
            aligned with the queries.
        bias: [B, 1, Sq, S] additive bias for the causal block.

    Returns:
        [B, Sq, H*D] attention output in q's dtype.
    """
    b, h, sq, d = q.shape
    kvh = keys[0].shape[1]
    s = keys[0].shape[2]
    g = h // kvh
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, kvh, g, sq, d).float()

    # causal block: [B, KVH, G, Sq, S] in fp32 (products of the working dtype)
    w0 = torch.einsum("bkgsd,bktd->bkgst", qg, keys[0].float()) * scale
    w0 = w0 + bias[:, :, None].float()
    extras = [
        (torch.einsum("bkgsd,bksd->bkgs", qg, ki.float()) * scale)[..., None]
        for ki in keys[1:]
    ]
    logits = torch.cat([w0] + extras, dim=-1) if extras else w0

    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", p[..., :s], values[0])
    for i, vi in enumerate(values[1:]):
        out = out + p[..., s + i, None] * vi[:, :, None]
    return out.reshape(b, h, sq, d).transpose(1, 2).reshape(b, sq, h * d)


#: queries a chunk of the chunked path holds
ATTENTION_Q_CHUNK = 256

#: sequences at or above this length (and a multiple of
#: :data:`ATTENTION_Q_CHUNK`) take the chunked path
CHUNKED_ATTENTION_MIN_SEQ = 1024


def ttt_branch_attention_chunked(
    q: torch.Tensor,
    keys: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    bias: torch.Tensor,
) -> torch.Tensor:
    """TTT branch attention over chunks of :data:`ATTENTION_Q_CHUNK`
    queries, each the dense path under activation checkpointing, so the
    scores held at a time are O(chunk · S) and the backward recomputes them
    (the long-sequence plain path). The branch diagonals are aligned with
    the queries, so a chunk reads only its own slice of each branch. S must
    be a multiple of the chunk."""
    outs = []
    for start in range(0, q.shape[2], ATTENTION_Q_CHUNK):
        rows = slice(start, start + ATTENTION_Q_CHUNK)
        outs.append(checkpoint(
            ttt_branch_attention_reference, q[:, :, rows],
            [keys[0]] + [ki[:, :, rows] for ki in keys[1:]],
            [values[0]] + [vi[:, :, rows] for vi in values[1:]],
            bias[:, :, rows],
            use_reentrant=False,
        ))
    return torch.cat(outs, dim=1)


def ttt_branch_attention(
    q: torch.Tensor,
    keys: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    bias: torch.Tensor,
) -> torch.Tensor:
    """The ``"dense"`` backend: dense for short sequences, chunked from
    :data:`CHUNKED_ATTENTION_MIN_SEQ` on."""
    s = q.shape[2]
    if s >= CHUNKED_ATTENTION_MIN_SEQ and s % ATTENTION_Q_CHUNK == 0:
        return ttt_branch_attention_chunked(q, keys, values, bias)
    return ttt_branch_attention_reference(q, keys, values, bias)


def dflash_attention(
    q: torch.Tensor,
    k_ctx: torch.Tensor,
    v_ctx: torch.Tensor,
    k_drf: torch.Tensor,
    v_drf: torch.Tensor,
    anchor_positions: torch.Tensor,
    block_keep_mask: torch.Tensor,
    block_size: int,
    chunk_blocks: int = 8,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """DFlash block attention, chunked over anchor blocks (the plain path).

    Each draft query block (at anchor a) attends to the context keys < a
    (optionally sliding-window-bounded) plus its own block's draft keys.
    Anchor blocks are processed in chunks under activation checkpointing:
    per chunk the keys are (full context ‖ own draft chunk), so memory is
    O(chunk · (S + chunk)) and the backward recomputes the scores.

    q, k_drf, v_drf: [B, H|KVH, N*block, D]; k_ctx, v_ctx: [B, KVH, S, D];
    anchor_positions, block_keep_mask: [B, N]. Returns [B, N*block, H*D].
    """
    b, h, q_len, d = q.shape
    kvh = k_ctx.shape[1]
    g = h // kvh
    n = anchor_positions.shape[1]
    cg = min(chunk_blocks, n) if chunk_blocks > 0 else n
    if n % cg != 0:
        raise ValueError(f"chunk_blocks {cg} must divide num anchors {n}")
    cq = cg * block_size
    scale = 1.0 / (d ** 0.5)
    s = k_ctx.shape[2]

    def chunk_attn(qc, kdc, vdc, anchors_c, keep_c):
        allow = dflash_chunk_mask(anchors_c, keep_c, s, block_size,
                                  sliding_window)  # [B, cq, S+cq]
        k_all = torch.cat([k_ctx, kdc], dim=2).float()
        v_all = torch.cat([v_ctx, vdc], dim=2)
        qg = qc.reshape(b, kvh, g, cq, d).float()
        w = torch.einsum("bkgsd,bktd->bkgst", qg, k_all) * scale
        w = torch.where(allow[:, None, None], w,
                        torch.full((), NEG_INF, dtype=w.dtype, device=w.device))
        p = torch.softmax(w, dim=-1).to(qc.dtype)
        out = torch.einsum("bkgst,bktd->bkgsd", p, v_all)
        keep_q = keep_c.repeat_interleave(block_size, dim=1)
        out = out * keep_q[:, None, None, :, None].to(out.dtype)
        return out.reshape(b, h, cq, d)

    outs = []
    for c in range(n // cg):
        rows = slice(c * cq, (c + 1) * cq)
        blocks = slice(c * cg, (c + 1) * cg)
        outs.append(checkpoint(
            chunk_attn, q[:, :, rows], k_drf[:, :, rows], v_drf[:, :, rows],
            anchor_positions[:, blocks], block_keep_mask[:, blocks],
            use_reentrant=False,
        ))
    out = torch.cat(outs, dim=2)
    return out.transpose(1, 2).reshape(b, q_len, h * d)


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
) -> torch.Tensor:
    """Plain dense attention with an additive bias (DFlash-family building
    block). q: [B, H, S, D], k/v: [B, KVH, T, D], bias broadcastable to
    [B, 1|H, S, T]. Returns [B, S, H*D]."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, kvh, g, s, d).float()
    w = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    if bias is not None:
        if bias.dim() == 4 and bias.shape[1] == 1:
            w = w + bias[:, :, None].float()
        else:
            w = w + bias.reshape(b, kvh, g, *bias.shape[-2:]).float()
    p = torch.softmax(w, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v)
    return out.reshape(b, h, s, d).transpose(1, 2).reshape(b, s, h * d)
