"""TTT branch flash attention: the hand-written Hopper kernel and its plain version.

Counterpart of ``specforge_tpu/ops/attention_pallas.py`` (``_fwd_pallas``
through ``ttt_flash_attention``). Step t of the TTT unroll attends causally to
the step-0 keys/values, masked by ``key_valid``, plus one query-aligned
diagonal key per earlier branch (not masked by ``key_valid``), all under one
joint softmax. The kernel is ``csrc/ttt_attention.cu``; the backward kernels
come with the training slice.

Layouts follow the JAX wrapper: q ``[B, H, S, D]``, each key/value
``[B, KVH, S, D]`` (the step-0 block first, then the branches in order),
``key_valid`` ``[B, S]``; the output is ``[B, S, H*D]`` and the row
statistics m, l are ``[B, H, S]`` fp32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

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
    tensors = [q, *keys, *values]
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the TTT attention backward kernels come with the training slice; "
            "call the forward under torch.no_grad()"
        )
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

    out = torch.empty((b, s, h * d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = cuda_lib.library()
    i64x3 = ctypes.c_longlong * 3
    ptrs = ctypes.c_void_p * len(keys)
    status = lib.ttt_attention_fwd(
        q.data_ptr(), i64x3(*_strides(q)),
        ptrs(*[k.data_ptr() for k in keys]),
        ptrs(*[v.data_ptr() for v in values]), len(keys),
        i64x3(*k_strides), i64x3(*v_strides), valid.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, h, kvh, s, d, torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_lib.check(status, "ttt_attention_fwd")
    ttt_flash_attention_fwd.launches += 1
    return out, m, l


#: kernel launches so far (plain CPU calls do not count)
ttt_flash_attention_fwd.launches = 0


def ttt_flash_attention(
    q: torch.Tensor,
    keys: Sequence[torch.Tensor],
    values: Sequence[torch.Tensor],
    key_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """TTT branch flash attention → [B, S, H*D] (the ``"pallas"`` backend)."""
    return ttt_flash_attention_fwd(q, keys, values, key_valid)[0]
