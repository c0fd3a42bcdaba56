"""P-EAGLE COD attention: the hand-written Hopper kernels and their plain versions.

Counterpart of ``specforge_tpu/ops/peagle_pallas.py`` (``_fwd_pallas`` and
``_bwd_pallas`` through ``cod_flash_attention``). Query q (anchor a_q, depth
d_q, doc c_q of its anchor, valid v_q) may attend key k iff

    c_q != -1 and c_q == c_k and v_q and v_k and
    ((d_k == 0 and a_q >= a_k)        # the depth-0 trunk, causally
     or (a_q == a_k and d_q >= d_k))  # the query's own rollout

The kernels are in ``csrc/peagle_attention.cu``: the forward, dq, and dk/dv,
on the Hopper forward, dq and dk/dv streams (``csrc/fwd_stream.cuh``,
``csrc/dq_stream.cuh``, ``csrc/dkv_stream.cuh``), which read q, k and v by
TMA: their (b, h, t) strides must be multiples of 8 elements and their bases
16-byte aligned. They read the four properties per token ([B, T, 4] int32,
one 16-byte load) and evaluate the predicate in registers; a [B, NT, NT]
table of the 64 x 64 tile pairs that hold an allowed pair (:func:`cod_tiles`,
built once per forward from the model's [B, T, T] mask and shared by every
layer and head) lets them skip the rest. Beside it, :func:`cod_tiles` marks
the tile pairs whose every pair is allowed (the kernels skip the predicate
there) and orders the dk/dv kernel's (batch, key tile) blocks and the
forward's and dq kernel's (batch, q tile) blocks longest first. A
row with no allowed key (an invalid slot, padding) gives out 0, m = -1e30
and l = 0, and gradient 0; the dense path averages uniformly there
instead, which changes no loss or gradient, since those rows are masked
from the loss and no valid row attends them.

Layouts follow the JAX wrapper: q ``[B, H, T, D]``, k and v ``[B, KVH, T,
D]`` (strided views of the merged ``qkv_proj`` output are read through
their strides; no kv head is repeated), the property vectors ``[B, T]``; the
output is ``[B, T, H*D]``, the row statistics m, l ``[B, H, T]`` fp32. Unlike
the JAX wrapper, a shape the kernels do not take raises: there is no
fallback to another path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from specforge_tpu_torch.ops import cuda_lib
from specforge_tpu_torch.ops.attention_cuda import backward_delta

NEG_INF = -1e30   # finite, as in the kernels
HEAD_DIMS = (64, 128)
TILE = 64         # rows and keys of a kernel tile (the skip table's unit)
#: elements of one plain-version score chunk [B, H, rows, T] (fp32)
PLAIN_CHUNK_ELEMENTS = 1 << 26

Tensor3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class CODTiles(NamedTuple):
    """What the kernels read besides q, k and v, built once per forward."""

    #: [B, T, 4] int32: anchor, depth, doc of the anchor (-1 pad), valid
    props: torch.Tensor
    #: [B, NT, NT] int32, NT = ceil(T / TILE): 1 where the tile pair (q tile,
    #: k tile) holds an allowed pair
    table: torch.Tensor
    #: [B, NT, NT] int32: 1 where every one of the tile pair's TILE x TILE
    #: pairs is allowed (whole tiles inside T only)
    full: torch.Tensor
    #: [B * NT] int32: the (batch, key tile) pairs b * NT + k, ordered by
    #: their live q tiles (the table's column sums), descending and stable:
    #: the dk/dv kernel's launch order
    order: torch.Tensor
    #: [B * NT] int32: the (batch, q tile) pairs b * NT + q, ordered by their
    #: live key tiles (the table's row sums), descending and stable: the
    #: forward's and the dq kernel's launch order
    dq_order: torch.Tensor


def _allow(qp: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
    """The predicate of [..., R, 4] query and [..., T, 4] key properties →
    [..., R, T] bool."""
    qa, qd, qc, qv = (qp[..., :, None, i] for i in range(4))
    ka, kd, kc, kv = (kp[..., None, :, i] for i in range(4))
    trunk = (kd == 0) & (qa >= ka)
    rollout = (qa == ka) & (qd >= kd)
    return (qc != -1) & (qc == kc) & (trunk | rollout) & (qv > 0) & (kv > 0)


def cod_props(anchor_pos, depth, doc, valid) -> torch.Tensor:
    """The four [..., T] property vectors packed as [..., T, 4] int32."""
    return torch.stack([anchor_pos.to(torch.int32), depth.to(torch.int32),
                        doc.to(torch.int32), valid.to(torch.int32)],
                       dim=-1).contiguous()


def cod_allow_dense(ap, dp, dc, vl) -> torch.Tensor:
    """[..., T, T] mask of the predicate (``dc`` the doc id of each token's
    anchor, -1 for padding; ``vl`` int): the XLA mirror of the kernels'
    predicate in ``peagle_pallas.py``, here over any leading dims."""
    props = cod_props(ap, dp, dc, vl)
    return _allow(props, props)


def block_order(table: torch.Tensor, dim: int) -> torch.Tensor:
    """A backward kernel's launch order of a [B, NT, NT] tile table → [B *
    NT] int32: the (batch, tile) pairs b * NT + i sorted by their live
    tiles, the table summed over ``dim`` (1: the dk/dv kernel's key tiles
    by their live q tiles; 2: the dq kernel's q tiles by their live key
    tiles), descending, ties in index order. On the table's device, with no
    host sync."""
    live = table.sum(dim=dim, dtype=torch.int32).flatten()
    order = torch.sort(live, descending=True, stable=True).indices
    return order.to(torch.int32)


def cod_tiles(anchor_pos, depth, doc, valid,
              allow_mask: Optional[torch.Tensor] = None) -> CODTiles:
    """Properties, the tile-skip table, the full-tile flags and the dk/dv
    and dq block orders of one sample ([B, T] vectors), from
    ``allow_mask`` [B, T, T] when the caller has it."""
    props = cod_props(anchor_pos, depth, doc, valid)
    if allow_mask is None:
        allow_mask = _allow(props, props)
    b, t = anchor_pos.shape
    nt = -(-t // TILE)
    padded = allow_mask.new_zeros((b, nt * TILE, nt * TILE))
    padded[:, :t, :t] = allow_mask
    tiled = padded.view(b, nt, TILE, nt, TILE)
    table = tiled.any(dim=4).any(dim=2).to(torch.int32).contiguous()
    # the padding past T is never allowed, so a tail tile is never full
    full = tiled.all(dim=4).all(dim=2).to(torch.int32).contiguous()
    return CODTiles(props, table, full, block_order(table, 1),
                    block_order(table, 2))


def _row_chunks(q: torch.Tensor):
    """Row chunks of the plain versions: as many rows as keep one chunk's
    fp32 scores under PLAIN_CHUNK_ELEMENTS."""
    b, h, t, _ = q.shape
    rows = max(1, PLAIN_CHUNK_ELEMENTS // (b * h * t))
    return [(r0, min(r0 + rows, t)) for r0 in range(0, t, rows)]


def _chunk_scores(q, k32, props, r0, r1):
    """fp32 scores [B, KVH, G, rows, T] of rows r0..r1, their allow-mask
    [B, 1, 1, rows, T] and the grouped fp32 q."""
    b, h, _, d = q.shape
    kvh = k32.shape[1]
    qg = q[:, :, r0:r1].float().reshape(b, kvh, h // kvh, r1 - r0, d)
    allow = _allow(props[:, r0:r1], props)[:, None, None]
    w = torch.einsum("bkgsd,bktd->bkgst", qg, k32) / (d ** 0.5)
    return qg, w, allow


def cod_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        props: torch.Tensor) -> Tensor3:
    """Plain PyTorch version of the forward kernel, in fp32 and chunked over
    rows → (out [B, T, H*D] in q's dtype, m [B, H, T], l [B, H, T]). Rows
    with no allowed key give out 0, m = -1e30, l = 0."""
    b, h, t, d = q.shape
    k32, v32 = k.float(), v.float()
    outs, ms, ls = [], [], []
    for r0, r1 in _row_chunks(q):
        _, w, allow = _chunk_scores(q, k32, props, r0, r1)
        w = torch.where(allow, w, torch.full_like(w, NEG_INF))
        m = w.amax(dim=-1, keepdim=True)
        p = torch.where(allow, torch.exp(w - m), torch.zeros_like(w))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgst,bktd->bkgsd", p, v32)
        outs.append((o / torch.clamp(l, min=1e-30)).reshape(b, h, r1 - r0, d))
        ms.append(m.reshape(b, h, r1 - r0))
        ls.append(l.reshape(b, h, r1 - r0))
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, t, h * d)
    return out.to(q.dtype), torch.cat(ms, dim=2), torch.cat(ls, dim=2)


def cod_attention_backward_plain(q, k, v, props, out, m, l, dout) -> Tensor3:
    """Plain PyTorch version of the backward, in fp32 and chunked over rows
    → (dq, dk, dv) in the inputs' dtypes: the formulas of ``_bwd_dq_kernel``
    and ``_bwd_dkv_kernel`` from the forward's (out, m, l), with
    delta = rowsum(dO · O)."""
    b, h, t, d = q.shape
    kvh = k.shape[1]
    g = h // kvh
    scale = 1.0 / (d ** 0.5)
    do_all = dout.float().reshape(b, t, kvh, g, d).permute(0, 2, 3, 1, 4)
    o_all = out.float().reshape(b, t, kvh, g, d).permute(0, 2, 3, 1, 4)
    delta_all = (do_all * o_all).sum(-1, keepdim=True)
    m_all = m.reshape(b, kvh, g, t, 1)
    l_all = torch.clamp(l.reshape(b, kvh, g, t, 1), min=1e-30)
    k32, v32 = k.float(), v.float()
    dq = torch.zeros((b, kvh, g, t, d), device=q.device)
    dk = torch.zeros((b, kvh, t, d), device=q.device)
    dv = torch.zeros_like(dk)
    for r0, r1 in _row_chunks(q):
        qg, w, allow = _chunk_scores(q, k32, props, r0, r1)
        do, delta = do_all[:, :, :, r0:r1], delta_all[:, :, :, r0:r1]
        p = torch.where(allow, torch.exp(w - m_all[:, :, :, r0:r1])
                        / l_all[:, :, :, r0:r1], torch.zeros_like(w))
        ds = p * (torch.einsum("bkgsd,bktd->bkgst", do, v32) - delta)
        dq[:, :, :, r0:r1] = torch.einsum("bkgst,bktd->bkgsd", ds, k32) * scale
        dk += torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale
        dv += torch.einsum("bkgst,bkgsd->bktd", p, do)
    return (dq.reshape(b, h, t, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _check_operand(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:3]):
        raise ValueError(
            f"{name} needs a contiguous head dim and (b, h, t) strides that "
            f"are multiples of 8 elements, got strides {tuple(x.stride())}"
        )
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_inputs(q, k, v, tiles: CODTiles):
    """Validate what the kernels take → (pointer array, stride array)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, D], got {tuple(q.shape)}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if k.dim() != 4:
        raise ValueError(f"k must be [B, KVH, T, D], got {tuple(k.shape)}")
    kvh = k.shape[1]
    if h % kvh:
        raise ValueError(f"H={h} must be a multiple of KVH={kvh}")
    for name, x, heads in (("q", q, h), ("k", k, kvh), ("v", v, kvh)):
        _check_operand(name, x, (b, heads, t, d), q.device)
    nt = -(-t // TILE)
    for name, x, shape in (("props", tiles.props, (b, t, 4)),
                           ("table", tiles.table, (b, nt, nt)),
                           ("full", tiles.full, (b, nt, nt)),
                           ("order", tiles.order, (b * nt,)),
                           ("dq_order", tiles.dq_order, (b * nt,))):
        if (x.device != q.device or x.dtype != torch.int32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(
                f"{name} must be contiguous int32 {shape} on {q.device}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if q.device.type != "cuda":
        raise ValueError(f"the COD kernels take CUDA tensors, got {q.device}")
    tensors = (q, k, v)
    ptrs = (ctypes.c_void_p * 3)(*[x.data_ptr() for x in tensors])
    strides = (ctypes.c_longlong * 9)(
        *[st for x in tensors for st in x.stride()[:3]])
    return ptrs, strides


def _dims(q, k):
    b, h, t, d = q.shape
    return b, h, k.shape[1], t, d


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def cod_attention_fwd(q, k, v, tiles: CODTiles) -> Tensor3:
    """COD attention forward → (out [B, T, H*D], m, l [B, H, T]).

    CPU tensors take :func:`cod_attention_plain`; CUDA tensors launch the
    kernel of ``csrc/peagle_attention.cu`` or raise."""
    if q.device.type == "cpu":
        return cod_attention_plain(q, k, v, tiles.props)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    ptrs, strides = _check_inputs(q, k, v, tiles)
    b, h, t, d = q.shape
    out = torch.empty((b, t, h * d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    status = cuda_lib.library().cod_attention_fwd(
        ptrs, strides, tiles.props.data_ptr(), tiles.table.data_ptr(),
        tiles.full.data_ptr(), tiles.dq_order.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), *_dims(q, k), _stream(q))
    cuda_lib.check(status, "cod_attention_fwd")
    cod_attention_fwd.launches += 1
    return out, m, l


#: kernel launches so far (plain CPU calls do not count)
cod_attention_fwd.launches = 0


def cod_attention_bwd_dq(q, k, v, tiles: CODTiles, dout, m, l, delta):
    """Launch the dq kernel → dq [B, H, T, D] contiguous bf16. ``dout`` is
    contiguous [B, T, H*D], ``delta`` from :func:`backward_delta`."""
    ptrs, strides = _check_inputs(q, k, v, tiles)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    status = cuda_lib.library().cod_attention_bwd_dq(
        ptrs, strides, tiles.props.data_ptr(), tiles.table.data_ptr(),
        tiles.full.data_ptr(), tiles.dq_order.data_ptr(),
        dout.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), *_dims(q, k), _stream(q))
    cuda_lib.check(status, "cod_attention_bwd_dq")
    cod_attention_bwd_dq.launches += 1
    return dq


#: kernel launches so far
cod_attention_bwd_dq.launches = 0


def cod_attention_bwd_dkv(q, k, v, tiles: CODTiles, dout, m, l, delta):
    """Launch the dk/dv kernel → (dk, dv) [B, KVH, T, D] contiguous bf16,
    summed over each group's query heads in the kernel. The operands are
    those of :func:`cod_attention_bwd_dq`."""
    ptrs, strides = _check_inputs(q, k, v, tiles)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    status = cuda_lib.library().cod_attention_bwd_dkv(
        ptrs, strides, tiles.props.data_ptr(), tiles.table.data_ptr(),
        tiles.full.data_ptr(), tiles.order.data_ptr(),
        dout.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *_dims(q, k), _stream(q))
    cuda_lib.check(status, "cod_attention_bwd_dkv")
    cod_attention_bwd_dkv.launches += 1
    return dk, dv


#: kernel launches so far
cod_attention_bwd_dkv.launches = 0


def _check_stats(name: str, x: torch.Tensor, shape, device) -> None:
    if (x.device != device or x.dtype != torch.float32
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
        raise ValueError(
            f"{name} must be contiguous float32 {tuple(shape)} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def cod_attention_bwd(q, k, v, tiles: CODTiles, out, m, l, dout) -> Tensor3:
    """COD attention backward → (dq, dk, dv).

    CPU tensors take :func:`cod_attention_backward_plain`; CUDA tensors
    launch the two backward kernels or raise. ``delta`` is one torch
    reduction."""
    if q.device.type == "cpu":
        return cod_attention_backward_plain(q, k, v, tiles.props, out, m, l,
                                            dout)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, t, d = q.shape
    for name, x in (("out", out), ("dout", dout)):
        if (x.device != q.device or x.dtype != q.dtype
                or tuple(x.shape) != (b, t, h * d)):
            raise ValueError(f"{name} must be {q.dtype} [B, T, H*D] on "
                             f"{q.device}")
    _check_stats("m", m, (b, h, t), q.device)
    _check_stats("l", l, (b, h, t), q.device)
    dout = dout.contiguous()
    args = (q, k, v, tiles, dout, m, l, backward_delta(out, dout, h))
    dq = cod_attention_bwd_dq(*args)
    dk, dv = cod_attention_bwd_dkv(*args)
    return dq, dk, dv


class _CODFlashAttention(torch.autograd.Function):
    """(q, k, v, *CODTiles) → out [B, T, H*D]; saves out, m, l."""

    @staticmethod
    def forward(ctx, q, k, v, *tiles):
        out, m, l = cod_attention_fwd(q, k, v, CODTiles(*tiles))
        ctx.save_for_backward(q, k, v, *tiles, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, *tiles, out, m, l = ctx.saved_tensors
        dq, dk, dv = cod_attention_bwd(q, k, v, CODTiles(*tiles), out, m, l,
                                       dout)
        return (dq, dk, dv) + (None,) * len(tiles)


def cod_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    anchor_pos: Optional[torch.Tensor] = None,
    depth: Optional[torch.Tensor] = None,
    doc: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    *,
    allow_mask: Optional[torch.Tensor] = None,
    tiles: Optional[CODTiles] = None,
) -> torch.Tensor:
    """COD attention with the mask computed in the kernel → ``[B, T, H*D]``
    (the ``"auto"``/``"pallas"`` backend), differentiable in q, k and v.

    Pass ``tiles`` (from :func:`cod_tiles`, built once per forward) to share
    the properties and the skip table between calls; else they are built
    here from the four [B, T] vectors (and ``allow_mask`` when given)."""
    if tiles is None:
        tiles = cod_tiles(anchor_pos, depth, doc, valid, allow_mask)
    return _CODFlashAttention.apply(q, k, v, *tiles)
