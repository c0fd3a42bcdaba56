"""DFlash block attention: the hand-written Hopper kernels and their plain versions.

Counterpart of ``specforge_tpu/ops/dflash_pallas.py`` (``_fwd_pallas`` and
``_bwd_pallas`` through ``dflash_flash_attention``). Query row r of anchor
block n (offset o = r % block_size, anchor a_n) attends, under one softmax,
to the context keys j < a_n (and j >= a_n + o - (w - 1) under a sliding
window w) and to its own block's draft keys (offsets <= o under a sliding
window); a block that is not kept attends to nothing and its rows are 0.
The kernels are in ``csrc/dflash_attention.cu``: the forward, and the
backward's two kernels (dq with the draft keys' dk/dv, and the context keys'
dk/dv). :func:`dflash_flash_attention` is a ``torch.autograd.Function`` over
them that returns a gradient for q and for each of the four key and value
tensors.

Layouts follow the JAX wrapper: q ``[B, H, Q, D]`` (Q = N · block_size),
k/v context ``[B, KVH, S, D]``, k/v draft ``[B, KVH, Q, D]``, anchors and
keep ``[B, N]``; the output is ``[B, Q, H*D]`` and the row statistics m, l
are ``[B, H, Q]`` fp32. The inputs may be strided views (the draft's merged
``qkv_proj`` output); the kernels read them through their strides and
repeat no kv head. Unlike the JAX wrapper, a shape the kernels do not take
raises: there is no fallback to another path.

The kernels take any block size from 1 to 64. They lay each block out at a
pitch, the smallest power of two not below the block size
(:func:`block_pitch`: 8 for DSpark's 7), so that a block divides their
64-row q tile; where the two differ, the wrappers copy q and the draft keys
and values (and, in the backward, dout and the row statistics) into that
layout with zero padding rows, and copy the results back. A padded row is
dead in the kernels (m = -1e30, l = 0) and never reaches the caller.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from specforge_tpu_torch.ops import cuda_lib
from specforge_tpu_torch.ops.attention_cuda import backward_delta
from specforge_tpu_torch.ops.masks import dflash_chunk_mask

NEG_INF = -1e30   # finite, as in the kernels
HEAD_DIMS = (64, 128)
Q_TILE = 64       # query rows of a kernel's q tile; a block's pitch divides it
#: elements of one plain-version score chunk [B, H, rows, S + rows] (fp32)
PLAIN_CHUNK_ELEMENTS = 1 << 26

Tensor5 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


def _plain_chunks(q, k_ctx, anchors, block_size):
    """Anchor chunks of the plain versions: as many blocks as keep one
    chunk's fp32 scores under PLAIN_CHUNK_ELEMENTS."""
    b, h, _, _ = q.shape
    s, n = k_ctx.shape[2], anchors.shape[1]
    cg = 1
    while (cg * 2 <= n and b * h * cg * 2 * block_size
           * (s + cg * 2 * block_size) <= PLAIN_CHUNK_ELEMENTS):
        cg *= 2
    return [(n0, min(n0 + cg, n)) for n0 in range(0, n, cg)]


def _chunk_scores(q, k_ctx, k_drf, anchors, keep, block_size, sliding_window,
                  n0, n1):
    """fp32 scores [B, KVH, G, rows, S + rows] of anchor blocks n0..n1 and
    their allow-mask, with the grouped fp32 q and the chunk's row slice."""
    b, h, _, d = q.shape
    kvh = k_ctx.shape[1]
    rows = slice(n0 * block_size, n1 * block_size)
    cq = (n1 - n0) * block_size
    qg = q[:, :, rows].float().reshape(b, kvh, h // kvh, cq, d)
    allow = dflash_chunk_mask(anchors[:, n0:n1], keep[:, n0:n1].bool(),
                              k_ctx.shape[2], block_size, sliding_window)
    k_all = torch.cat([k_ctx.float(), k_drf[:, :, rows].float()], dim=2)
    w = torch.einsum("bkgsd,bktd->bkgst", qg, k_all) / (d ** 0.5)
    return qg, w, allow[:, None, None], rows


def dflash_flash_attention_plain(
    q: torch.Tensor,
    k_ctx: torch.Tensor,
    v_ctx: torch.Tensor,
    k_drf: torch.Tensor,
    v_drf: torch.Tensor,
    anchors: torch.Tensor,
    keep: torch.Tensor,
    block_size: int,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel, in fp32 and chunked over
    anchors → (out [B, Q, H*D] in q's dtype, m [B, H, Q], l [B, H, Q]).
    Rows of blocks not kept give out 0, m = -1e30, l = 0."""
    b, h, q_len, d = q.shape
    s = k_ctx.shape[2]
    outs, ms, ls = [], [], []
    for n0, n1 in _plain_chunks(q, k_ctx, anchors, block_size):
        _, w, allow, rows = _chunk_scores(q, k_ctx, k_drf, anchors, keep,
                                          block_size, sliding_window, n0, n1)
        w = torch.where(allow, w, torch.full_like(w, NEG_INF))
        m = w.amax(dim=-1, keepdim=True)
        p = torch.where(allow, torch.exp(w - m), torch.zeros_like(w))
        l = p.sum(dim=-1, keepdim=True)
        o = (torch.einsum("bkgst,bktd->bkgsd", p[..., :s], v_ctx.float())
             + torch.einsum("bkgst,bktd->bkgsd", p[..., s:],
                            v_drf[:, :, rows].float()))
        cq = o.shape[3]
        outs.append((o / torch.clamp(l, min=1e-30)).reshape(b, h, cq, d))
        ms.append(m.reshape(b, h, cq))
        ls.append(l.reshape(b, h, cq))
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, q_len, h * d)
    return out.to(q.dtype), torch.cat(ms, dim=2), torch.cat(ls, dim=2)


def dflash_flash_attention_backward_plain(
    q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
    sliding_window, out, m, l, dout,
) -> Tensor5:
    """Plain PyTorch version of the backward, in fp32 and chunked over
    anchors → (dq, dk_ctx, dv_ctx, dk_drf, dv_drf) in the inputs' dtypes:
    the formulas of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` from the
    forward's (out, m, l), with delta = rowsum(dO · O)."""
    b, h, q_len, d = q.shape
    kvh = k_ctx.shape[1]
    g = h // kvh
    s = k_ctx.shape[2]
    scale = 1.0 / (d ** 0.5)
    do_all = dout.float().reshape(b, q_len, kvh, g, d).permute(0, 2, 3, 1, 4)
    o_all = out.float().reshape(b, q_len, kvh, g, d).permute(0, 2, 3, 1, 4)
    delta_all = (do_all * o_all).sum(-1, keepdim=True)
    m_all = m.reshape(b, kvh, g, q_len, 1)
    l_all = torch.clamp(l.reshape(b, kvh, g, q_len, 1), min=1e-30)
    kc32, vc32 = k_ctx.float(), v_ctx.float()
    dq = torch.zeros((b, kvh, g, q_len, d), device=q.device)
    dkc = torch.zeros((b, kvh, s, d), device=q.device)
    dvc = torch.zeros_like(dkc)
    dkd = torch.zeros((b, kvh, q_len, d), device=q.device)
    dvd = torch.zeros_like(dkd)
    for n0, n1 in _plain_chunks(q, k_ctx, anchors, block_size):
        qg, w, allow, rows = _chunk_scores(q, k_ctx, k_drf, anchors, keep,
                                           block_size, sliding_window, n0, n1)
        do, delta = do_all[:, :, :, rows], delta_all[:, :, :, rows]
        p = torch.where(allow, torch.exp(w - m_all[:, :, :, rows])
                        / l_all[:, :, :, rows], torch.zeros_like(w))
        kd32, vd32 = k_drf[:, :, rows].float(), v_drf[:, :, rows].float()
        v_all = torch.cat([vc32, vd32], dim=2)
        dp = torch.einsum("bkgsd,bktd->bkgst", do, v_all)
        ds = p * (dp - delta)
        k_all = torch.cat([kc32, kd32], dim=2)
        dq[:, :, :, rows] = torch.einsum("bkgst,bktd->bkgsd", ds, k_all) * scale
        dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale
        dv = torch.einsum("bkgst,bkgsd->bktd", p, do)
        dkc += dk[:, :, :s]
        dvc += dv[:, :, :s]
        dkd[:, :, rows] = dk[:, :, s:]
        dvd[:, :, rows] = dv[:, :, s:]
    return (dq.reshape(b, h, q_len, d).to(q.dtype), dkc.to(k_ctx.dtype),
            dvc.to(v_ctx.dtype), dkd.to(k_drf.dtype), dvd.to(v_drf.dtype))


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def block_pitch(block_size: int) -> int:
    """Rows a block takes in the kernels' layout: the smallest power of two
    not below ``block_size`` (the rows past ``block_size`` are padding)."""
    return 1 << (block_size - 1).bit_length()


def _pitch_rows(x: torch.Tensor, dim: int, block_size: int,
                fill: float = 0.0) -> torch.Tensor:
    """``x`` with rows ``[N * block_size]`` along ``dim`` → a contiguous copy
    with rows ``[N * pitch]``, each block's padding rows set to ``fill``; ``x``
    itself where the pitch is the block size."""
    pitch = block_pitch(block_size)
    if pitch == block_size:
        return x
    blocks = x.unflatten(dim, (-1, block_size))
    shape = list(blocks.shape)
    shape[dim + 1] = pitch
    out = blocks.new_full(shape, fill)
    out.narrow(dim + 1, 0, block_size).copy_(blocks)
    return out.flatten(dim, dim + 1)


def _unpitch_rows(x: torch.Tensor, dim: int, block_size: int) -> torch.Tensor:
    """The inverse of :func:`_pitch_rows`: the real rows, contiguous."""
    pitch = block_pitch(block_size)
    if pitch == block_size:
        return x
    return x.unflatten(dim, (-1, pitch)).narrow(dim + 1, 0, block_size).flatten(
        dim, dim + 1)


def _check_operand(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:3]):
        raise ValueError(
            f"{name} needs a contiguous head dim and (b, h, s) strides that "
            f"are multiples of 8 elements, got strides {tuple(x.stride())}"
        )
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_inputs(q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
                  sliding_window):
    """Validate what the kernels take → (the five operands, q and the draft
    keys and values in the pitched layout; int32 anchors, int32 keep,
    window)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, Q, D], got {tuple(q.shape)}")
    b, h, q_len, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if anchors.dim() != 2 or anchors.shape[0] != b:
        raise ValueError(f"anchors must be [B, N], got {tuple(anchors.shape)}")
    n = anchors.shape[1]
    if not 1 <= block_size <= Q_TILE:
        raise ValueError(
            f"block_size {block_size} must lie in 1..{Q_TILE} (its pitch "
            f"must divide the q tile of {Q_TILE} rows)")
    if q_len != n * block_size:
        raise ValueError(f"q has {q_len} rows, expected N*block_size = "
                         f"{n * block_size}")
    if k_ctx.dim() != 4:
        raise ValueError(f"k_ctx must be [B, KVH, S, D], got {tuple(k_ctx.shape)}")
    kvh, s = k_ctx.shape[1], k_ctx.shape[2]
    if s < 1 or h % kvh:
        raise ValueError(f"bad shapes: H={h}, KVH={kvh}, S={s}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be positive, got {sliding_window}")
    for name, x, rows in (("q", q, None), ("k_ctx", k_ctx, s),
                          ("v_ctx", v_ctx, s), ("k_drf", k_drf, q_len),
                          ("v_drf", v_drf, q_len)):
        shape = (b, h, q_len, d) if rows is None else (b, kvh, rows, d)
        _check_operand(name, x, shape, q.device)
    if tuple(keep.shape) != (b, n) or anchors.device != q.device or (
            keep.device != q.device):
        raise ValueError(f"anchors and keep must be [B, N] on {q.device}")
    tensors = (_pitch_rows(q, 2, block_size), k_ctx, v_ctx,
               _pitch_rows(k_drf, 2, block_size),
               _pitch_rows(v_drf, 2, block_size))
    return (tensors, anchors.to(torch.int32).contiguous(),
            keep.to(torch.int32).contiguous(), sliding_window or 0)


def _pointers(tensors):
    """The operands' (pointer array, stride array over (b, head, row))."""
    ptrs = (ctypes.c_void_p * 5)(*[x.data_ptr() for x in tensors])
    strides = (ctypes.c_longlong * 15)(
        *[st for x in tensors for st in x.stride()[:3]])
    return ptrs, strides


def _dims(q, k_ctx, anchors, block_size, window):
    b, h, _, d = q.shape
    return (b, h, k_ctx.shape[1], k_ctx.shape[2], anchors.shape[1],
            block_size, window, d)


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def dflash_flash_attention_fwd(
    q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
    sliding_window=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DFlash block attention forward → (out [B, Q, H*D], m, l [B, H, Q]).

    CPU tensors take :func:`dflash_flash_attention_plain`; CUDA tensors
    launch the kernel of ``csrc/dflash_attention.cu`` or raise."""
    if q.device.type == "cpu":
        return dflash_flash_attention_plain(
            q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
            sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    tensors, a32, k32, window = _check_inputs(
        q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
        sliding_window)
    ptrs, strides = _pointers(tensors)
    b, h, rows, d = tensors[0].shape
    out = torch.empty((b, rows, h * d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, rows), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    status = cuda_lib.library().dflash_attention_fwd(
        ptrs, strides, a32.data_ptr(), k32.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(),
        *_dims(q, k_ctx, anchors, block_size, window), _stream(q))
    cuda_lib.check(status, "dflash_attention_fwd")
    dflash_flash_attention_fwd.launches += 1
    return (_unpitch_rows(out, 1, block_size), _unpitch_rows(m, 2, block_size),
            _unpitch_rows(l, 2, block_size))


#: kernel launches so far (plain CPU calls do not count)
dflash_flash_attention_fwd.launches = 0


def _dq_heads(d: int, block_size: int) -> int:
    """Query heads a dq block keeps resident: four, or two where the draft
    staging (64 x max(pitch, 16) bf16 of p and of ds a head) does not fit
    beside four at D = 128."""
    return 4 if d == 64 or block_pitch(block_size) <= 16 else 2


def _check_stats(name: str, x: torch.Tensor, shape, device) -> None:
    if (x.device != device or x.dtype != torch.float32
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
        raise ValueError(
            f"{name} must be contiguous float32 {tuple(shape)} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _bwd_operands(q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
                  sliding_window, dout, m, l, delta):
    """Validate the backward kernels' operands → (the five operands, int32
    anchors, int32 keep, window, dout, m, l, delta), all in the pitched
    layout (padded rows: dout 0, m -1e30, l 0, delta 0, dead rows)."""
    tensors, a32, k32, window = _check_inputs(
        q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
        sliding_window)
    b, h, q_len, d = q.shape
    if (dout.device != q.device or dout.dtype != q.dtype
            or tuple(dout.shape) != (b, q_len, h * d)):
        raise ValueError(f"dout must be {q.dtype} [B, Q, H*D] on {q.device}")
    for name, x in (("m", m), ("l", l), ("delta", delta)):
        _check_stats(name, x, (b, h, q_len), q.device)
    return (tensors, a32, k32, window,
            _pitch_rows(dout.contiguous(), 1, block_size),
            _pitch_rows(m, 2, block_size, NEG_INF),
            _pitch_rows(l, 2, block_size), _pitch_rows(delta, 2, block_size))


def _launch_bwd_dq(q, k_ctx, anchors, block_size, operands):
    """Kernel A on pitched operands → pitched (dq, draft dk, draft dv)."""
    tensors, a32, k32, window, dout, m, l, delta = operands
    ptrs, strides = _pointers(tensors)
    b, h, rows, d = tensors[0].shape
    kvh = k_ctx.shape[1]
    heads = _dq_heads(d, block_size)
    dq = torch.empty((b, h, rows, d), dtype=q.dtype, device=q.device)
    dkd = torch.empty((b, kvh, rows, d), dtype=tensors[3].dtype,
                      device=q.device)
    dvd = torch.empty_like(dkd)
    # past one chunk of resident heads the group sums go through fp32
    ws = (torch.empty((2, b, kvh, rows, d), dtype=torch.float32,
                      device=q.device) if h // kvh > heads else None)
    status = cuda_lib.library().dflash_attention_bwd_dq(
        ptrs, strides, a32.data_ptr(), k32.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dkd.data_ptr(), dvd.data_ptr(),
        None if ws is None else ws.data_ptr(), heads,
        *_dims(q, k_ctx, anchors, block_size, window), _stream(q))
    cuda_lib.check(status, "dflash_attention_bwd_dq")
    dflash_attention_bwd_dq.launches += 1
    return dq, dkd, dvd


def _launch_bwd_dkv(q, k_ctx, anchors, block_size, operands):
    """Kernel B on pitched operands → (dk, dv) of the context keys."""
    tensors, a32, k32, window, dout, m, l, delta = operands
    ptrs, strides = _pointers(tensors)
    dkc = torch.empty(k_ctx.shape, dtype=k_ctx.dtype, device=q.device)
    dvc = torch.empty_like(dkc)
    status = cuda_lib.library().dflash_attention_bwd_dkv(
        ptrs, strides, a32.data_ptr(), k32.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dkc.data_ptr(),
        dvc.data_ptr(),
        *_dims(q, k_ctx, anchors, block_size, window), _stream(q))
    cuda_lib.check(status, "dflash_attention_bwd_dkv")
    dflash_attention_bwd_dkv.launches += 1
    return dkc, dvc


def dflash_attention_bwd_dq(q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep,
                            block_size, sliding_window, dout, m, l, delta):
    """Launch kernel A → (dq [B, H, Q, D], draft dk, draft dv [B, KVH, Q,
    D]), contiguous bf16, the draft gradients summed over each group's
    query heads in the kernel. ``dout`` is [B, Q, H*D], ``m``, ``l`` the
    forward's, ``delta`` from :func:`backward_delta`."""
    dq, dkd, dvd = _launch_bwd_dq(q, k_ctx, anchors, block_size, _bwd_operands(
        q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
        sliding_window, dout, m, l, delta))
    return tuple(_unpitch_rows(x, 2, block_size) for x in (dq, dkd, dvd))


#: kernel launches so far
dflash_attention_bwd_dq.launches = 0


def dflash_attention_bwd_dkv(q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep,
                             block_size, sliding_window, dout, m, l, delta):
    """Launch kernel B → (dk, dv) of the context keys [B, KVH, S, D]
    contiguous bf16, summed over each group's query heads in the kernel.
    The operands are those of :func:`dflash_attention_bwd_dq`."""
    return _launch_bwd_dkv(q, k_ctx, anchors, block_size, _bwd_operands(
        q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
        sliding_window, dout, m, l, delta))


#: kernel launches so far
dflash_attention_bwd_dkv.launches = 0


def dflash_flash_attention_bwd(
    q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size, sliding_window,
    out, m, l, dout,
) -> Tensor5:
    """DFlash block attention backward → (dq, dk_ctx, dv_ctx, dk_drf,
    dv_drf).

    CPU tensors take :func:`dflash_flash_attention_backward_plain`; CUDA
    tensors launch the two backward kernels or raise. ``delta`` is one
    torch reduction; kernel A sums the draft dk/dv over each group's query
    heads itself. The operands are put in the pitched layout once for both
    kernels."""
    if q.device.type == "cpu":
        return dflash_flash_attention_backward_plain(
            q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
            sliding_window, out, m, l, dout)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, q_len, d = q.shape
    if (out.device != q.device or out.dtype != q.dtype
            or tuple(out.shape) != (b, q_len, h * d)):
        raise ValueError(f"out must be {q.dtype} [B, Q, H*D] on {q.device}")
    operands = _bwd_operands(
        q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
        sliding_window, dout, m, l, backward_delta(out, dout, h))
    dq, dkd, dvd = _launch_bwd_dq(q, k_ctx, anchors, block_size, operands)
    dkc, dvc = _launch_bwd_dkv(q, k_ctx, anchors, block_size, operands)
    return (_unpitch_rows(dq, 2, block_size), dkc, dvc,
            _unpitch_rows(dkd, 2, block_size),
            _unpitch_rows(dvd, 2, block_size))


class _DFlashFlashAttention(torch.autograd.Function):
    """(q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep) → out [B, Q, H*D];
    saves out, m, l."""

    @staticmethod
    def forward(ctx, q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep,
                block_size, sliding_window):
        out, m, l = dflash_flash_attention_fwd(
            q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, block_size,
            sliding_window)
        ctx.block_size = block_size
        ctx.sliding_window = sliding_window
        ctx.save_for_backward(q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep,
                              out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, out, m, l = (
            ctx.saved_tensors)
        grads = dflash_flash_attention_bwd(
            q, k_ctx, v_ctx, k_drf, v_drf, anchors, keep, ctx.block_size,
            ctx.sliding_window, out, m, l, dout)
        return (*grads, None, None, None, None)


def dflash_flash_attention(
    q: torch.Tensor,
    k_ctx: torch.Tensor,
    v_ctx: torch.Tensor,
    k_drf: torch.Tensor,
    v_drf: torch.Tensor,
    anchors: torch.Tensor,
    keep: torch.Tensor,
    block_size: int,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """DFlash block attention with the mask computed in the kernel →
    ``[B, Q, H*D]`` (the ``"auto"``/``"pallas"`` backend), differentiable in
    q and in the four key and value tensors."""
    return _DFlashFlashAttention.apply(q, k_ctx, v_ctx, k_drf, v_drf,
                                       anchors, keep, block_size,
                                       sliding_window)
