"""TTT branch flash attention: the hand-written Hopper kernels and their plain versions.

Counterpart of ``specforge_tpu/ops/attention_pallas.py`` (``_fwd_pallas``
and ``_bwd_pallas`` through ``ttt_flash_attention``). Step t of the TTT
unroll attends causally to the step-0 keys/values, masked by ``key_valid``,
plus one query-aligned diagonal key per earlier branch (not masked by
``key_valid``), all under one joint softmax. The kernels are in
``csrc/ttt_attention.cu``: the forward, and the backward's two kernels (dq
with the branch dk/dv, and the causal block's dk/dv).
:func:`ttt_flash_attention` is a ``torch.autograd.Function`` over them that
returns a gradient for q and for every key and value, so each branch's
gradient reaches the TTT step that made it.

Layouts follow the JAX wrapper: q ``[B, H, S, D]``, each key/value
``[B, KVH, S, D]`` (the step-0 block first, then the branches in order),
``key_valid`` ``[B, S]``; the output is ``[B, S, H*D]`` and the row
statistics m, l are ``[B, H, S]`` fp32. q, keys and values may be strided
views (of the draft's merged ``qkv_proj`` output); the kernels read them
through their strides. The gradients come out contiguous.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from specforge_tpu_torch.ops import cuda_lib

NEG_INF = -1e30  # finite, as in the kernel
MAX_KEYS = 8     # the step-0 block plus up to 7 branches
HEAD_DIMS = (64, 128)


def ttt_flash_attention_plain(
    q: torch.Tensor,
    keys: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    key_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, in fp32 → (out, m, l).

    A row that may attend to nothing returns 0, like the kernel (the dense
    path averages uniformly there instead)."""
    b, h, s, d = q.shape
    kvh = keys[0].shape[1]
    g = h // kvh
    scale = 1.0 / (d ** 0.5)
    qg = q.float().reshape(b, kvh, g, s, d)
    w0 = torch.einsum("bkgsd,bktd->bkgst", qg, keys[0].float()) * scale
    row = torch.arange(s, device=q.device)
    allow = (row[None, :] <= row[:, None])[None, None, None]
    if key_valid is not None:
        allow = allow & (key_valid != 0)[:, None, None, None, :]
    w0 = torch.where(allow, w0, torch.full_like(w0, NEG_INF))
    wb = [
        torch.einsum("bkgsd,bksd->bkgs", qg, kb.float())[..., None] * scale
        for kb in keys[1:]
    ]
    logits = torch.cat([w0] + wb, dim=-1)
    m = logits.max(dim=-1, keepdim=True).values
    p = torch.exp(logits - m)
    p = torch.cat([torch.where(allow, p[..., :s], 0.0), p[..., s:]], dim=-1)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgst,bktd->bkgsd", p[..., :s], values[0].float())
    for i, vb in enumerate(values[1:]):
        out = out + p[..., s + i, None] * vb.float()[:, :, None]
    out = out / torch.clamp(l, min=1e-30)
    out = out.reshape(b, h, s, d).transpose(1, 2).reshape(b, s, h * d)
    return (
        out.to(q.dtype),
        m.reshape(b, h, s),
        l.reshape(b, h, s),
    )


def ttt_flash_attention_backward_plain(
    q: torch.Tensor,
    keys: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    key_valid: Optional[torch.Tensor],
    out: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    dout: torch.Tensor,
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Plain PyTorch version of the backward, in fp32 → (dq, dkeys, dvalues)
    in the inputs' dtypes; the formulas of ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``, from the forward's (out, m, l)."""
    b, h, s, d = q.shape
    kvh = keys[0].shape[1]
    g = h // kvh
    scale = 1.0 / (d ** 0.5)
    qg = q.float().reshape(b, kvh, g, s, d)
    do = dout.float().reshape(b, s, kvh, g, d).permute(0, 2, 3, 1, 4)
    o = out.float().reshape(b, s, kvh, g, d).permute(0, 2, 3, 1, 4)
    delta = (do * o).sum(-1, keepdim=True)
    mg = m.reshape(b, kvh, g, s, 1)
    lg = torch.clamp(l.reshape(b, kvh, g, s, 1), min=1e-30)
    k0, v0 = keys[0].float(), values[0].float()
    row = torch.arange(s, device=q.device)
    allow = (row[None, :] <= row[:, None])[None, None, None]
    if key_valid is not None:
        allow = allow & (key_valid != 0)[:, None, None, None, :]
    sc = torch.einsum("bkgsd,bktd->bkgst", qg, k0) * scale
    p = torch.where(allow, torch.exp(sc - mg) / lg, 0.0)
    dp = torch.einsum("bkgsd,bktd->bkgst", do, v0.float())
    ds = p * (dp - delta)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k0) * scale
    dkeys = [torch.einsum("bkgst,bkgsd->bktd", ds, qg) * scale]
    dvalues = [torch.einsum("bkgst,bkgsd->bktd", p, do)]
    for kb, vb in zip(keys[1:], values[1:]):
        kb32, vb32 = kb.float()[:, :, None], vb.float()[:, :, None]
        pb = torch.exp((qg * kb32).sum(-1, keepdim=True) * scale - mg) / lg
        dsb = pb * ((do * vb32).sum(-1, keepdim=True) - delta)
        dq = dq + dsb * kb32 * scale
        dkeys.append((dsb * qg * scale).sum(2))
        dvalues.append((pb * do).sum(2))
    return (
        dq.reshape(b, h, s, d).to(q.dtype),
        [dk.to(k.dtype) for dk, k in zip(dkeys, keys)],
        [dv.to(v.dtype) for dv, v in zip(dvalues, values)],
    )


def _strides(x: torch.Tensor) -> Tuple[int, int, int]:
    return x.stride(0), x.stride(1), x.stride(2)


def _check_operand(name: str, x: torch.Tensor, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, q on {device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if x.stride(-1) != 1 or any(st % 8 for st in _strides(x)):
        raise ValueError(
            f"{name} needs a contiguous head dim and (b, h, s) strides that "
            f"are multiples of 8 elements, got strides {tuple(x.stride())}"
        )
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def ttt_flash_attention_fwd(
    q: torch.Tensor,
    keys: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    key_valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """TTT flash attention forward → (out [B,S,H*D], m [B,H,S], l [B,H,S]).

    CPU tensors take :func:`ttt_flash_attention_plain`; CUDA tensors launch
    the kernel of ``csrc/ttt_attention.cu`` or raise."""
    if q.device.type == "cpu":
        return ttt_flash_attention_plain(q, keys, values, key_valid)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    valid, k_strides, v_strides = _check_inputs(q, keys, values, key_valid)
    b, h, s, d = q.shape
    kvh = keys[0].shape[1]
    out = torch.empty((b, s, h * d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    status = cuda_lib.library().ttt_attention_fwd(
        q.data_ptr(), _i64x3(_strides(q)), *_pointer_arrays(keys, values),
        len(keys), _i64x3(k_strides), _i64x3(v_strides), valid.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, h, kvh, s, d, torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(status, "ttt_attention_fwd")
    ttt_flash_attention_fwd.launches += 1
    return out, m, l


#: kernel launches so far (plain CPU calls do not count)
ttt_flash_attention_fwd.launches = 0


def _i64x3(values) -> ctypes.Array:
    return (ctypes.c_longlong * 3)(*values)


def _pointer_arrays(keys, values) -> Tuple[ctypes.Array, ctypes.Array]:
    ptrs = ctypes.c_void_p * len(keys)
    return (ptrs(*[k.data_ptr() for k in keys]),
            ptrs(*[v.data_ptr() for v in values]))


def _check_inputs(q, keys, values, key_valid):
    """Validate what the kernels take → (int32 key validity [B, S], key
    strides, value strides)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, S, D], got {tuple(q.shape)}")
    b, h, s, d = q.shape
    if not 1 <= len(keys) <= MAX_KEYS or len(values) != len(keys):
        raise ValueError(
            f"need 1..{MAX_KEYS} keys and as many values, got "
            f"{len(keys)} and {len(values)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    kvh = keys[0].shape[1]
    if h % kvh or b * h > 65535:
        raise ValueError(f"bad head counts: H={h}, KVH={kvh}, B={b}")
    _check_operand("q", q, (b, h, s, d), q.device)
    for i, (k, v) in enumerate(zip(keys, values)):
        _check_operand(f"keys[{i}]", k, (b, kvh, s, d), q.device)
        _check_operand(f"values[{i}]", v, (b, kvh, s, d), q.device)
    k_strides, v_strides = _strides(keys[0]), _strides(values[0])
    if any(_strides(k) != k_strides for k in keys) or any(
        _strides(v) != v_strides for v in values
    ):
        raise ValueError("all keys (and all values) must share one layout")
    if key_valid is None:
        valid = torch.ones((b, s), dtype=torch.int32, device=q.device)
    else:
        if tuple(key_valid.shape) != (b, s) or key_valid.device != q.device:
            raise ValueError(
                f"key_valid must be [B, S] on {q.device}, got "
                f"{tuple(key_valid.shape)} on {key_valid.device}"
            )
        valid = (key_valid != 0).to(torch.int32).contiguous()
    return valid, k_strides, v_strides


def _check_stats(name: str, x: torch.Tensor, shape, device) -> None:
    if (x.device != device or x.dtype != torch.float32
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
        raise ValueError(
            f"{name} must be contiguous float32 {tuple(shape)} on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )


def backward_delta(out: torch.Tensor, dout: torch.Tensor,
                   num_heads: int) -> torch.Tensor:
    """``delta = rowsum(dO·O)`` per (batch, head, row) of [B, S, H*D]
    outputs → [B, H, S] fp32: one torch reduction (the JAX version computes
    it outside its kernels too)."""
    b, s, hd = out.shape
    delta = (dout.float() * out.float()).view(b, s, num_heads, -1).sum(-1)
    return delta.transpose(1, 2).contiguous()


def ttt_attention_bwd_dq(q, keys, values, valid, dout, m, l, delta):
    """Launch the dq kernel → (dq [B, H, S, D], branch dk and dv per query
    head [NB, B, H, S, D]), all contiguous bf16. The operands are those
    :func:`ttt_flash_attention_bwd` checked: ``valid`` int32 [B, S],
    ``dout`` contiguous, ``delta`` from :func:`backward_delta`."""
    b, h, s, d = q.shape
    kvh = keys[0].shape[1]
    nb = len(keys) - 1
    dq = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    dkb = torch.empty((nb, b, h, s, d), dtype=q.dtype, device=q.device)
    dvb = torch.empty_like(dkb)
    status = cuda_lib.library().ttt_attention_bwd_dq(
        q.data_ptr(), _i64x3(_strides(q)), *_pointer_arrays(keys, values),
        len(keys), _i64x3(_strides(keys[0])), _i64x3(_strides(values[0])),
        valid.data_ptr(),
        dout.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dkb.data_ptr(), dvb.data_ptr(),
        b, h, kvh, s, d, torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(status, "ttt_attention_bwd_dq")
    ttt_attention_bwd_dq.launches += 1
    return dq, dkb, dvb


#: kernel launches so far
ttt_attention_bwd_dq.launches = 0


def ttt_attention_bwd_dkv(q, keys, values, valid, dout, m, l, delta):
    """Launch the causal dk/dv kernel → (dk, dv) [B, KVH, S, D] contiguous
    bf16, summed over the query heads of each group in the kernel. The
    operands are those of :func:`ttt_attention_bwd_dq`."""
    b, h, s, d = q.shape
    kvh = keys[0].shape[1]
    dk = torch.empty((b, kvh, s, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    status = cuda_lib.library().ttt_attention_bwd_dkv(
        q.data_ptr(), _i64x3(_strides(q)), *_pointer_arrays(keys, values),
        len(keys), _i64x3(_strides(keys[0])), _i64x3(_strides(values[0])),
        valid.data_ptr(),
        dout.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        b, h, kvh, s, d, torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(status, "ttt_attention_bwd_dkv")
    ttt_attention_bwd_dkv.launches += 1
    return dk, dv


#: kernel launches so far
ttt_attention_bwd_dkv.launches = 0


def ttt_flash_attention_bwd(
    q: torch.Tensor,
    keys: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    key_valid: Optional[torch.Tensor],
    out: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    dout: torch.Tensor,
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """TTT flash attention backward → (dq, dkeys, dvalues), one gradient per
    key and value in their order.

    CPU tensors take :func:`ttt_flash_attention_backward_plain`; CUDA tensors
    launch the two backward kernels of ``csrc/ttt_attention.cu`` or raise.
    ``delta = rowsum(dO·O)`` is one torch reduction, and the branch dk/dv
    that the dq kernel writes per query head are summed over each group's
    H/KVH heads by one more (in fp32), as the JAX version sums them outside
    its kernel too."""
    if q.device.type == "cpu":
        return ttt_flash_attention_backward_plain(
            q, keys, values, key_valid, out, m, l, dout)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    valid, _, _ = _check_inputs(q, keys, values, key_valid)
    b, h, s, d = q.shape
    kvh = keys[0].shape[1]
    for name, x in (("out", out), ("dout", dout)):
        if (x.device != q.device or x.dtype != q.dtype
                or tuple(x.shape) != (b, s, h * d)):
            raise ValueError(f"{name} must be {q.dtype} [B, S, H*D] on {q.device}")
    _check_stats("m", m, (b, h, s), q.device)
    _check_stats("l", l, (b, h, s), q.device)
    dout = dout.contiguous()
    args = (q, keys, values, valid, dout, m, l, backward_delta(out, dout, h))
    dq, dkb, dvb = ttt_attention_bwd_dq(*args)
    dk, dv = ttt_attention_bwd_dkv(*args)
    nb = len(keys) - 1
    if nb:
        def group_sum(x):
            return x.view(nb, b, kvh, h // kvh, s, d).sum(
                3, dtype=torch.float32).to(q.dtype)

        dkb, dvb = group_sum(dkb), group_sum(dvb)
    return dq, [dk, *dkb.unbind(0)], [dv, *dvb.unbind(0)]


class _TTTFlashAttention(torch.autograd.Function):
    """(q, key_valid, *keys, *values) → out [B, S, H*D]; saves out, m, l."""

    @staticmethod
    def forward(ctx, q, key_valid, *kv):
        n = len(kv) // 2
        keys, values = kv[:n], kv[n:]
        out, m, l = ttt_flash_attention_fwd(q, keys, values, key_valid)
        ctx.n_keys = n
        ctx.key_valid = key_valid  # an integer mask: no gradient
        ctx.save_for_backward(q, out, m, l, *kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, out, m, l, *kv = ctx.saved_tensors
        n = ctx.n_keys
        dq, dkeys, dvalues = ttt_flash_attention_bwd(
            q, kv[:n], kv[n:], ctx.key_valid, out, m, l, dout)
        return (dq, None, *dkeys, *dvalues)


def ttt_flash_attention(
    q: torch.Tensor,
    keys: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    key_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """TTT branch flash attention → [B, S, H*D] (the ``"pallas"`` backend),
    differentiable in q and in every key and value."""
    if len(keys) != len(values):
        raise ValueError(f"{len(keys)} keys but {len(values)} values")
    return _TTTFlashAttention.apply(q, key_valid, *keys, *values)
