"""Fused draft-vocab CE forward: the hand-written Hopper kernel and its plain version.

Counterpart of ``specforge_tpu/ops/loss_pallas.py`` (``loss_forward_pallas``).
One streaming pass over the vocab computes, per row,

    row_loss = -(sum_v t·x - (sum_v t)·(m + log d)) · mask

and ``loss = sum(row_loss) / (B·T)``; the row statistics (m, d, ts) are saved
for the backward, which comes with the training slice. The kernel is
``csrc/fused_ce.cu``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from specforge_tpu_torch.ops import cuda_lib

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def loss_forward_plain(
    logits: torch.Tensor, target_p: torch.Tensor, position_mask: torch.Tensor
) -> Tuple[torch.Tensor, Stats]:
    """Plain PyTorch version → (loss, (m, d, ts, mask)), stats [B, T, 1] fp32."""
    f32 = logits.float()
    m = f32.max(dim=-1, keepdim=True).values
    d = torch.exp(f32 - m).sum(dim=-1, keepdim=True)
    t32 = target_p.float()
    ts = t32.sum(dim=-1, keepdim=True)
    s1 = (t32 * f32).sum(dim=-1, keepdim=True)
    mask = (position_mask != 0).float()
    row_loss = -(s1 - ts * (m + torch.log(d))) * mask
    return row_loss.mean(), (m, d, ts, mask)


def loss_forward(
    logits: torch.Tensor, target_p: torch.Tensor, position_mask: torch.Tensor
) -> Tuple[torch.Tensor, Stats]:
    """Fused CE forward on [B, T, V] logits/teacher and a [B, T, 1] mask.

    CPU tensors take :func:`loss_forward_plain`; CUDA tensors launch the
    kernel of ``csrc/fused_ce.cu`` or raise."""
    if logits.device.type == "cpu":
        return loss_forward_plain(logits, target_p, position_mask)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    if logits.requires_grad or target_p.requires_grad:
        raise NotImplementedError(
            "the fused CE backward kernel comes with the training slice; "
            "call the forward under torch.no_grad()"
        )
    if logits.dim() != 3:
        raise ValueError(f"logits must be [B, T, V], got {tuple(logits.shape)}")
    b, t, v = logits.shape
    if tuple(target_p.shape) != (b, t, v):
        raise ValueError(
            f"target_p has shape {tuple(target_p.shape)}, expected {(b, t, v)}"
        )
    if position_mask.numel() != b * t:
        raise ValueError(
            f"position_mask has {position_mask.numel()} entries, expected {b * t}"
        )
    if logits.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"logits must be bfloat16 or float32, got {logits.dtype}")
    if target_p.dtype != torch.float32:
        raise TypeError(f"target_p must be float32, got {target_p.dtype}")
    for name, x in (("logits", logits), ("target_p", target_p),
                    ("position_mask", position_mask)):
        if x.device != logits.device:
            raise ValueError(f"{name} is on {x.device}, logits on {logits.device}")
        if name != "position_mask" and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    rows = b * t
    mask = (position_mask.reshape(rows) != 0).to(torch.int32)
    row_loss, m, d, ts = (
        torch.empty(rows, dtype=torch.float32, device=logits.device)
        for _ in range(4)
    )
    status = cuda_lib.library().fused_ce_fwd(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16),
        target_p.data_ptr(), mask.data_ptr(), row_loss.data_ptr(),
        m.data_ptr(), d.data_ptr(), ts.data_ptr(), rows, v,
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    cuda_lib.check(status, "fused_ce_fwd")
    loss_forward.launches += 1
    loss = row_loss.sum() / rows
    col = (b, t, 1)
    return loss, (m.view(col), d.view(col), ts.view(col),
                  mask.view(col).float())


#: kernel launches so far (plain CPU calls do not count)
loss_forward.launches = 0
