"""Dense TTT branch attention (the ``"dense"`` backend) and the causal bias.

Counterpart of ``specforge_tpu/ops/attention.py``. At TTT step ``t`` the
query attends (a) fully causally to the step-0 keys/values and (b) to exactly
one key per earlier TTT branch — the key at its own position — with all
logits normalized by one joint softmax. GQA is handled by grouped einsums
over [B, KVH, G, S, D], without repeating the keys.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

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
        q: [B, H, S, D] roped queries of the current step.
        keys/values: per-branch [B, KVH, S, D]; branch 0 is the full causal
            block, branches 1..t contribute one diagonal key each.
        bias: [B, 1, S, S] additive bias for the causal block.

    Returns:
        [B, S, H*D] attention output in q's dtype.
    """
    b, h, s, d = q.shape
    kvh = keys[0].shape[1]
    g = h // kvh
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, kvh, g, s, d).float()

    # causal block: [B, KVH, G, S, S] in fp32 (products of the working dtype)
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
    return out.reshape(b, h, s, d).transpose(1, 2).reshape(b, s, h * d)
