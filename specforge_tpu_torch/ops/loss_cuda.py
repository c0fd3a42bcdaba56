"""Fused draft-vocab CE: the hand-written Hopper kernels and their plain versions.

Counterpart of ``specforge_tpu/ops/loss_pallas.py`` (``loss_forward_pallas``
and ``loss_backward_pallas``). The forward makes one streaming pass over the
vocab and computes, per row,

    row_loss = -(sum_v t·x - (sum_v t)·(m + log d)) · mask

and ``loss = sum(row_loss) / (B·T)``; it saves the row statistics (m, d, ts)
for the backward, one elementwise pass

    grad = -(t·g - softmax(x)·ts·g) · mask,   g = dL / (B·T).

Both kernels are in ``csrc/fused_ce.cu``. The teacher may be a window of a
longer [B, T', V] tensor (a TTT step's slice of the padded teacher): the
kernels read it through its batch stride, so no copy of it is made.
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


def loss_backward_plain(
    logits: torch.Tensor, target_p: torch.Tensor, stats: Stats,
    g: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the backward (``ops/loss.py:73-85`` of the
    JAX package) → the logits' gradient in their dtype."""
    m, d, ts, mask = stats
    b, t, _ = logits.shape
    scale = g.float() / (b * t)
    softmax = torch.exp(logits.float() - m) / d
    grad = -(target_p.float() * scale - softmax * (ts * scale)) * mask
    return grad.to(logits.dtype)


def _check(logits, target_p, position_mask) -> Tuple[int, int, int, int]:
    """Validate the operands the kernels take → (B, T, V, teacher stride)."""
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
    for name, x in (("target_p", target_p), ("position_mask", position_mask)):
        if x.device != logits.device:
            raise ValueError(f"{name} is on {x.device}, logits on {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    # the teacher's rows must be contiguous within each batch; batches may
    # sit at any stride (a window of the padded teacher)
    if target_p.stride(2) != 1 or (t > 1 and target_p.stride(1) != v):
        raise ValueError(
            "target_p needs contiguous [T, V] rows within each batch, got "
            f"strides {tuple(target_p.stride())}"
        )
    return b, t, v, target_p.stride(0) if b > 1 else t * v


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
    b, t, v, t_sb = _check(logits, target_p, position_mask)
    rows = b * t
    mask = (position_mask.reshape(rows) != 0).to(torch.int32)
    row_loss, m, d, ts = (
        torch.empty(rows, dtype=torch.float32, device=logits.device)
        for _ in range(4)
    )
    status = cuda_lib.library().fused_ce_fwd(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16),
        target_p.data_ptr(), mask.data_ptr(), row_loss.data_ptr(),
        m.data_ptr(), d.data_ptr(), ts.data_ptr(), rows, v, t, t_sb,
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


def loss_backward(
    logits: torch.Tensor, target_p: torch.Tensor, stats: Stats,
    g: torch.Tensor,
) -> torch.Tensor:
    """Fused CE backward: the gradient of the loss in ``logits``, from the
    forward's statistics and the upstream gradient ``g`` (a scalar tensor).

    CPU tensors take :func:`loss_backward_plain`; CUDA tensors launch the
    kernel of ``csrc/fused_ce.cu`` or raise."""
    if logits.device.type == "cpu":
        return loss_backward_plain(logits, target_p, stats, g)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    m, d, ts, mask = stats
    b, t, v, t_sb = _check(logits, target_p, mask)
    rows = b * t
    for name, x in (("m", m), ("d", d), ("ts", ts)):
        if x.dtype != torch.float32 or x.numel() != rows or not x.is_contiguous():
            raise ValueError(f"{name} must be {rows} contiguous float32 values")
    if g.numel() != 1 or g.device != logits.device:
        raise ValueError("g must be one value on the logits' device")
    mask_i = (mask.reshape(rows) != 0).to(torch.int32)
    g32 = g.reshape(1).to(torch.float32)
    grad = torch.empty_like(logits)
    status = cuda_lib.library().fused_ce_bwd(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16),
        target_p.data_ptr(), m.data_ptr(), d.data_ptr(), ts.data_ptr(),
        mask_i.data_ptr(), g32.data_ptr(), grad.data_ptr(), rows, v, t, t_sb,
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    cuda_lib.check(status, "fused_ce_bwd")
    loss_backward.launches += 1
    return grad


#: kernel launches so far (plain CPU calls do not count)
loss_backward.launches = 0
