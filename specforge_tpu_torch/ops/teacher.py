"""Teacher projection for EAGLE-family training.

Counterpart of ``specforge_tpu/ops/teacher.py``. Given the frozen target's
full-vocab logits (or its last hidden state plus the frozen ``lm_head``
weight), produce what the TTT loop consumes:

- ``target_p``          — teacher distribution renormalized over the draft vocab.
- ``accept_ratio``      — per-position ``exp(lse_draft - lse_full)``; the
                          un-renormalized draft-vocab teacher is exactly
                          ``target_p * accept_ratio``.
- ``target_token_ids``  — full-vocab argmax token ids.
- ``position_mask``     — ``t2d[argmax] * loss_mask``.

The head products are plain ``torch`` matrix products with fp32 output; the
compact path streams the full-vocab logsumexp/argmax over vocab chunks so the
[B, S, V] fp32 logits never exist at once.

Vocab maps: ``t2d`` bool [vocab] (draft membership), ``d2t`` int [draft_vocab]
(target_index = draft_index + d2t[draft_index]).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

DEFAULT_VOCAB_CHUNK_SIZE = 32768

Teacher = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, K] @ [K, M] with an fp32 result; bf16/fp16 operands accumulate in
    fp32 and are never rounded to their own type (``preferred_element_type``
    of the JAX package)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    if dtype == torch.float32:
        return a.float() @ b.float()
    return torch.mm(a.to(dtype), b.to(dtype), out_dtype=torch.float32)


def draft_gather_indices(d2t: torch.Tensor) -> torch.Tensor:
    """Target-vocab gather indices for each draft-vocab slot: ``i + d2t[i]``."""
    return torch.arange(d2t.shape[0], device=d2t.device, dtype=d2t.dtype) + d2t


def _project(
    draft_logits: torch.Tensor,
    log_z: torch.Tensor,
    token_ids: torch.Tensor,
    t2d: torch.Tensor,
    loss_mask: torch.Tensor,
) -> Teacher:
    target_p = torch.softmax(draft_logits, dim=-1)
    lse_draft = torch.logsumexp(draft_logits, dim=-1, keepdim=True)
    accept_ratio = torch.exp(lse_draft - log_z)
    in_draft = t2d[token_ids][..., None].to(torch.int32)
    position_mask = in_draft * loss_mask.to(torch.int32)
    return target_p, accept_ratio, token_ids, position_mask


def compute_target_p(
    target_logits: torch.Tensor,
    t2d: torch.Tensor,
    d2t: torch.Tensor,
    loss_mask: torch.Tensor,
) -> Teacher:
    """Full-vocab teacher projection of [B, S, V] logits → (target_p
    [B,S,Vd] f32, accept_ratio [B,S,1] f32, token ids [B,S] int64,
    position_mask [B,S,1] int32)."""
    t = target_logits.float()
    token_ids = torch.argmax(t, dim=-1)
    draft_logits = t.index_select(-1, draft_gather_indices(d2t))
    log_z = torch.logsumexp(t, dim=-1, keepdim=True)
    return _project(draft_logits, log_z, token_ids, t2d, loss_mask)


def _pad_teacher(
    target_p: torch.Tensor,
    accept_ratio: torch.Tensor,
    target_token_ids: torch.Tensor,
    length: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pad by ``length`` along the sequence: target_p with the uniform
    1/V_draft distribution, the ratio and the token ids with 0."""
    v_draft = target_p.shape[-1]
    return (
        F.pad(target_p, (0, 0, 0, length), value=1.0 / v_draft),
        F.pad(accept_ratio, (0, 0, 0, length), value=0.0),
        F.pad(target_token_ids, (0, length), value=0),
    )


def compute_target_p_padded(
    target_logits: torch.Tensor,
    t2d: torch.Tensor,
    d2t: torch.Tensor,
    loss_mask: torch.Tensor,
    length: int,
) -> Teacher:
    """Full-vocab teacher projection padded by the TTT length."""
    target_p, accept_ratio, token_ids, position_mask = compute_target_p(
        target_logits, t2d, d2t, loss_mask
    )
    return (*_pad_teacher(target_p, accept_ratio, token_ids, length),
            position_mask)


def tiled_logsumexp_argmax(
    hidden: torch.Tensor,
    weight: torch.Tensor,
    chunk_size: int = DEFAULT_VOCAB_CHUNK_SIZE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-vocab fp32 logsumexp [..., 1] and argmax [...] without [..., V]
    logits: the head product streams over vocab chunks; ties resolve to the
    lowest index."""
    vocab_size, h = weight.shape
    lead_shape = hidden.shape[:-1]
    hidden2d = hidden.reshape(-1, h)
    n_rows = hidden2d.shape[0]
    dev = hidden.device
    run_max = torch.full((n_rows,), float("-inf"), device=dev)
    run_sumexp = torch.zeros(n_rows, device=dev)
    run_argval = torch.full((n_rows,), float("-inf"), device=dev)
    run_argmax = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    for lo in range(0, vocab_size, chunk_size):
        logits = matmul_f32(hidden2d, weight[lo:lo + chunk_size].T)
        chunk_idx = torch.argmax(logits, dim=-1)  # first of equal maxima
        chunk_val = logits.gather(-1, chunk_idx[:, None])[:, 0]
        new_max = torch.maximum(run_max, chunk_val)
        run_sumexp = run_sumexp * torch.exp(run_max - new_max) + torch.exp(
            logits - new_max[:, None]
        ).sum(dim=-1)
        run_max = new_max
        take = chunk_val > run_argval  # strict > keeps the lowest index
        run_argmax = torch.where(take, chunk_idx + lo, run_argmax)
        run_argval = torch.where(take, chunk_val, run_argval)
    log_z = run_max + torch.log(run_sumexp)
    return log_z.reshape(*lead_shape, 1), run_argmax.reshape(lead_shape)


def compute_target_p_from_hidden(
    hidden: torch.Tensor,
    lm_head_weight: torch.Tensor,
    t2d: torch.Tensor,
    d2t: torch.Tensor,
    loss_mask: torch.Tensor,
    chunk_size: int = DEFAULT_VOCAB_CHUNK_SIZE,
) -> Teacher:
    """Compact teacher: :func:`compute_target_p` from last hidden states
    ``hidden`` [B, S, H] and ``lm_head_weight`` [V, H]."""
    b, s, h = hidden.shape
    draft_head = lm_head_weight.index_select(0, draft_gather_indices(d2t))
    draft_logits = matmul_f32(
        hidden.reshape(b * s, h), draft_head.T
    ).reshape(b, s, -1)
    log_z, token_ids = tiled_logsumexp_argmax(
        hidden, lm_head_weight, chunk_size=chunk_size
    )
    return _project(draft_logits, log_z, token_ids, t2d, loss_mask)


def compute_target_p_padded_from_hidden(
    hidden: torch.Tensor,
    lm_head_weight: torch.Tensor,
    t2d: torch.Tensor,
    d2t: torch.Tensor,
    loss_mask: torch.Tensor,
    length: int,
    chunk_size: int = DEFAULT_VOCAB_CHUNK_SIZE,
) -> Teacher:
    """Compact teacher with the +length TTT padding applied."""
    target_p, accept_ratio, token_ids, position_mask = (
        compute_target_p_from_hidden(
            hidden, lm_head_weight, t2d, d2t, loss_mask, chunk_size=chunk_size
        )
    )
    return (*_pad_teacher(target_p, accept_ratio, token_ids, length),
            position_mask)
