"""Offset-causal flash attention with an LSE output: the USP ring hop.

Counterpart of ``flash_attention_lse`` in
``specforge_tpu/ops/attention_pallas.py`` (``_lse_fwd_kernel``,
``_lse_bwd_dq_kernel``, ``_lse_bwd_dkv_kernel``). One ring hop attends the
local queries (global rows ``row_off + i``) to one K/V chunk (global columns
``col_off + j``) under global causality: key j is allowed for row i when
``j + col_off <= i + row_off`` and ``key_valid[bh, j] != 0``. It returns the
normalised output and the row log-sum-exp, so the hops and the TTT branch
logits merge by log-sum-exp outside (``parallel/usp.py``). A row with no
allowed key gives out = 0 and lse = -1e30 (finite, as in the TPU kernel).

The kernels are in ``csrc/lse_attention.cu``: the forward, dq and dk/dv on
the Hopper forward, dq and dk/dv streams (``csrc/fwd_stream.cuh``,
``csrc/dq_stream.cuh``, ``csrc/dkv_stream.cuh``), which read q, k, v and dO
by TMA: their bases must be 16-byte aligned. The offsets are Python ints
(the rank and the hop are host values in the port; JAX traced them).
:func:`flash_attention_lse` is a ``torch.autograd.Function`` whose backward
takes the gradients of both outputs: ``dstat = rowsum(dO·O) - dlse`` is
one torch reduction in the wrapper, as the JAX version computes it outside
its kernels.

Layouts follow the JAX op: q ``[BH, Sq, D]``, k and v ``[BH, Sk, D]``,
``key_valid`` ``[BH, Sk]``; out ``[BH, Sq, D]`` in q's dtype and lse
``[BH, Sq, 1]`` fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from specforge_tpu_torch.ops import cuda_lib

NEG_INF = -1e30  # finite, as in the kernel
HEAD_DIMS = (64, 128)


def _allow(key_valid: torch.Tensor, sq: int, sk: int, row_off: int,
           col_off: int) -> torch.Tensor:
    """[BH, Sq, Sk] bool: ``col + col_off <= row + row_off`` and valid."""
    row = torch.arange(sq, device=key_valid.device)[:, None] + row_off
    col = torch.arange(sk, device=key_valid.device)[None, :] + col_off
    return (col <= row)[None] & (key_valid != 0)[:, None, :]


def flash_attention_lse_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_valid: torch.Tensor, row_off: int, col_off: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward, in fp32 → (out [BH, Sq, D] in
    q's dtype, lse [BH, Sq, 1] fp32): the formulas of ``_lse_fwd_kernel``."""
    sq, d = q.shape[1], q.shape[2]
    scale = 1.0 / (d ** 0.5)
    allow = _allow(key_valid, sq, k.shape[1], row_off, col_off)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = torch.where(allow, s, torch.full_like(s, NEG_INF))
    m = s.max(dim=-1, keepdim=True).values
    p = torch.where(allow, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()) / torch.clamp(
        l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, NEG_INF))
    return out.to(q.dtype), lse


def backward_dstat(out: torch.Tensor, dout: torch.Tensor,
                   dlse: torch.Tensor) -> torch.Tensor:
    """``dstat = rowsum(dO·O) - dlse`` → [BH, Sq] fp32 (the joint row
    statistic of ``ds = p·(dp - delta + dlse)``)."""
    delta = (dout.float() * out.float()).sum(-1)
    return (delta - dlse.float().reshape(delta.shape)).contiguous()


def flash_attention_lse_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_valid: torch.Tensor, row_off: int, col_off: int,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    dlse: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, in fp32 → (dq, dk, dv) in the
    inputs' dtypes: the formulas of ``_lse_bwd_dq_kernel`` and
    ``_lse_bwd_dkv_kernel``, from the forward's (out, lse) and the
    gradients of both."""
    sq, d = q.shape[1], q.shape[2]
    scale = 1.0 / (d ** 0.5)
    allow = _allow(key_valid, sq, k.shape[1], row_off, col_off)
    q32, k32, v32, do = q.float(), k.float(), v.float(), dout.float()
    dstat = backward_dstat(out, dout, dlse)[..., None]
    s = torch.einsum("bqd,bkd->bqk", q32, k32) * scale
    p = torch.where(allow, torch.exp(s - lse.float().reshape(dstat.shape)),
                    0.0)
    dp = torch.einsum("bqd,bkd->bqk", do, v32)
    ds = p * (dp - dstat)
    dq = torch.einsum("bqk,bkd->bqd", ds, k32) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q32) * scale
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_inputs(q, k, v, key_valid) -> None:
    """Validate what the kernels take; raise on a mismatch."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q, k, v must be [BH, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not 1 <= bh <= 65535:
        raise ValueError(f"BH={bh} outside 1..65535")
    for name, x, shape in (("q", q, (bh, sq, d)), ("k", k, (bh, sk, d)),
                           ("v", v, (bh, sk, d))):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got "
                             f"{tuple(x.shape)} strides {tuple(x.stride())}")
        _check_aligned(name, x)
    if (tuple(key_valid.shape) != (bh, sk) or key_valid.device != q.device
            or key_valid.dtype != torch.int32
            or not key_valid.is_contiguous()):
        raise ValueError(
            f"key_valid must be contiguous int32 [BH, Sk] = {(bh, sk)} on "
            f"{q.device}, got {key_valid.dtype} {tuple(key_valid.shape)} on "
            f"{key_valid.device}")


def _check_aligned(name: str, x: torch.Tensor) -> None:
    """The kernels copy 16 bytes at a time (TMA): a base that is not
    16-byte aligned raises."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary, got "
                         f"address {x.data_ptr():#x}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def lse_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_valid: torch.Tensor, row_off: int, col_off: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward → (out [BH, Sq, D], lse [BH, Sq, 1] fp32).

    CPU tensors take :func:`flash_attention_lse_plain`; CUDA tensors launch
    the kernel of ``csrc/lse_attention.cu`` or raise."""
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, key_valid, row_off, col_off)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_inputs(q, k, v, key_valid)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    status = cuda_lib.library().lse_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_valid.data_ptr(),
        out.data_ptr(), lse.data_ptr(), bh, sq, k.shape[1], d, int(row_off),
        int(col_off), _stream(q))
    cuda_lib.check(status, "lse_attention_fwd")
    lse_attention_fwd.launches += 1
    return out, lse


#: kernel launches so far (plain CPU calls do not count)
lse_attention_fwd.launches = 0


def _check_backward(q, out, lse, dout, dlse) -> None:
    bh, sq, d = q.shape
    for name, x, dtype, shape in (
            ("out", out, q.dtype, (bh, sq, d)),
            ("dout", dout, q.dtype, (bh, sq, d)),
            ("lse", lse, torch.float32, (bh, sq, 1))):
        if (x.device != q.device or x.dtype != dtype
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{name} must be contiguous {dtype} {shape} on {q.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    _check_aligned("dout", dout)
    if dlse.numel() != bh * sq or dlse.device != q.device:
        raise ValueError(f"dlse must hold [BH, Sq, 1] = {(bh, sq, 1)} on "
                         f"{q.device}, got {tuple(dlse.shape)}")


def lse_attention_bwd_dq(q, k, v, valid, row_off, col_off, dout, lse, dstat):
    """Launch the dq kernel → dq [BH, Sq, D] contiguous bf16. The operands
    are those :func:`lse_attention_bwd` checked: ``valid`` int32 [BH, Sk],
    ``dout`` contiguous and 16-byte aligned, ``dstat`` from
    :func:`backward_dstat`."""
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    status = cuda_lib.library().lse_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dstat.data_ptr(), dq.data_ptr(),
        bh, sq, k.shape[1], d, int(row_off), int(col_off), _stream(q))
    cuda_lib.check(status, "lse_attention_bwd_dq")
    lse_attention_bwd_dq.launches += 1
    return dq


#: kernel launches so far
lse_attention_bwd_dq.launches = 0


def lse_attention_bwd_dkv(q, k, v, valid, row_off, col_off, dout, lse, dstat):
    """Launch the dk/dv kernel → (dk, dv) [BH, Sk, D] contiguous bf16, each
    summed over the q tiles in a fixed order (no atomics). The operands are
    those of :func:`lse_attention_bwd_dq`."""
    bh, sq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    status = cuda_lib.library().lse_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dstat.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bh, sq, k.shape[1], d, int(row_off), int(col_off),
        _stream(q))
    cuda_lib.check(status, "lse_attention_bwd_dkv")
    lse_attention_bwd_dkv.launches += 1
    return dk, dv


#: kernel launches so far
lse_attention_bwd_dkv.launches = 0


def lse_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_valid: torch.Tensor, row_off: int, col_off: int,
    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
    dlse: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward → (dq, dk, dv) from the forward's (out, lse) and the
    gradients (dout, dlse) of both.

    CPU tensors take :func:`flash_attention_lse_backward_plain`; CUDA
    tensors launch the two backward kernels of ``csrc/lse_attention.cu`` or
    raise."""
    if q.device.type == "cpu":
        return flash_attention_lse_backward_plain(
            q, k, v, key_valid, row_off, col_off, out, lse, dout, dlse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_inputs(q, k, v, key_valid)
    dout = dout.contiguous()
    _check_backward(q, out, lse, dout, dlse)
    args = (q, k, v, key_valid, row_off, col_off, dout, lse,
            backward_dstat(out, dout, dlse))
    dq = lse_attention_bwd_dq(*args)
    dk, dv = lse_attention_bwd_dkv(*args)
    return dq, dk, dv


class _FlashAttentionLSE(torch.autograd.Function):
    """(q, k, v, key_valid, row_off, col_off) → (out, lse); saves both."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, row_off, col_off):
        out, lse = lse_attention_fwd(q, k, v, key_valid, row_off, col_off)
        ctx.offsets = (row_off, col_off)
        ctx.key_valid = key_valid  # an integer mask: no gradient
        ctx.save_for_backward(q, k, v, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = lse_attention_bwd(q, k, v, ctx.key_valid, *ctx.offsets,
                                       out, lse, dout, dlse)
        return dq, dk, dv, None, None, None


def flash_attention_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    key_valid: torch.Tensor, row_off: int, col_off: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Offset-causal flash attention → (out [BH, Sq, D], lse [BH, Sq, 1]),
    differentiable in q, k and v through both outputs."""
    return _FlashAttentionLSE.apply(q, k, v, key_valid, int(row_off),
                                    int(col_off))
