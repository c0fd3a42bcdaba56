"""USP sequence parallelism: Ulysses (head-scatter all-to-all) × Ring
attention, composed with the EAGLE3 TTT branch-cache merge.

Counterpart of ``specforge_tpu/parallel/usp.py`` with the ring hop of
``_ring_ttt_attention_pallas`` (``:68-125``). The JAX package shard_maps one
global program; here every rank runs its own process (``parallel/mesh.py``)
and holds one sequence chunk:

- **Ulysses**: ``all_to_all`` over the Ulysses group scatters heads and
  gathers sequence, [B, H, S_loc, D] → [B, H/U, U·S_loc, D], so each rank
  attends a ring chunk of S_g = U·S_loc positions with a head subset
  (:class:`_UlyssesExchange`, whose backward is the inverse exchange).
- **Ring**: the step-0 (causal) K/V chunks rotate around the ring group;
  each hop runs the offset-causal LSE kernel (``ops/lse_attention_cuda.py``)
  with host-int offsets and returns (out, lse). One autograd Function
  (:class:`_RingLSEAttention`) runs all R hops, so every rank issues its
  collectives in one fixed order; its backward walks the hops, launches the
  dq and dk/dv kernels and carries each chunk's dk/dv around the ring with
  the chunk (fp32, summed in a fixed order) until it reaches its owner, as
  ring flash attention does.
- **TTT branches**: branch K/V are position-diagonal, so after the Ulysses
  exchange they are local: one extra logit per branch joins the hops in a
  log-sum-exp merge, plain autograd, as in the JAX package.

**Transport.** NCCL where each rank has a card of its own; gloo over host
copies where ranks share one card (NCCL refuses two ranks on one GPU) and on
the CPU (:func:`~specforge_tpu_torch.parallel.multihost.plan_transport`, the
mesh's ``transport``). :data:`COLLECTIVES` counts the calls, bytes and host
seconds spent in them.

:func:`mesh_sum` sums a value over every rank of the mesh (each holds its
own batch block and sequence chunk) in the forward and passes its gradient
through unchanged: a loss term or metric that is a function of globally
summed numerators and denominators is then the same on every rank, and each
rank's gradient is its own share, summed over the ranks by the train step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from specforge_tpu_torch.ops.lse_attention_cuda import (
    lse_attention_bwd,
    lse_attention_fwd,
)
from specforge_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e30

#: collective calls, bytes moved and host seconds spent in them
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0}
#: when set, a collective on a card waits for the card before and after it,
#: so that its seconds are its own: NCCL calls return before the card has
#: run them (host-staged gloo waits in its copies anyway). For measurement
#: only: it stalls the host.
TIMED = False


def reset_collective_stats() -> None:
    COLLECTIVES.update(calls=0, bytes=0, seconds=0.0)


class Staged:
    """A collective over the mesh's transport: NCCL on the tensors' own
    device, or gloo on host copies copied back after the call."""

    def __init__(self, mesh: Mesh, tensors: Sequence[torch.Tensor]):
        self.device = tensors[0].device
        self.host = mesh.transport == "gloo" and self.device.type == "cuda"
        self.sync = TIMED and self.device.type == "cuda"
        if self.sync:
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        COLLECTIVES["calls"] += 1
        COLLECTIVES["bytes"] += sum(t.numel() * t.element_size()
                                    for t in tensors)

    def stage(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        return x.cpu() if self.host else x

    def done(self, x: torch.Tensor) -> torch.Tensor:
        out = x.to(self.device) if self.host else x
        if self.sync:
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()  # a call may return several tensors
        COLLECTIVES["seconds"] += now - self.t0
        self.t0 = now
        return out


def all_to_all(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``all_to_all_single`` over the Ulysses group: chunk i of the leading
    axis goes to Ulysses rank i; chunk i of the result came from it."""
    call = Staged(mesh, [x])
    src = call.stage(x)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.ulysses_group)
    return call.done(out)


def ring_shift(tensors: Sequence[torch.Tensor], mesh: Mesh
               ) -> List[torch.Tensor]:
    """Send each tensor to the next ring rank and receive the previous
    rank's (``ppermute`` with ``i → i+1``), all in one batch of P2P ops."""
    call = Staged(mesh, tensors)
    r, ring = mesh.ring_rank, mesh.ring_ranks
    dst, src = ring[(r + 1) % len(ring)], ring[(r - 1) % len(ring)]
    sends = [call.stage(t) for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = []
    for s, v in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, dst, group=mesh.ring_group))
        ops.append(dist.P2POp(dist.irecv, v, src, group=mesh.ring_group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [call.done(v) for v in recvs]


def all_reduce_sum(x: torch.Tensor, mesh: Mesh,
                   group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (every rank of the mesh when None),
    as a new tensor; every rank gets the same bits."""
    call = Staged(mesh, [x])
    y = call.stage(x).clone()
    dist.all_reduce(y, group=group)
    return call.done(y)


def all_gather_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B, S_loc, ...] → [B, U·S_loc, ...] over the Ulysses group, in
    Ulysses rank order (no gradient)."""
    call = Staged(mesh, [x])
    src = call.stage(x)
    parts = [torch.empty_like(src) for _ in range(mesh.ulysses_size)]
    dist.all_gather(parts, src, group=mesh.ulysses_group)
    return call.done(torch.cat(parts, dim=1))


class _MeshSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


def mesh_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum over every rank of the mesh in the forward, the gradient passed
    through unchanged (each rank keeps its own share); ``x`` itself without
    a mesh or in a mesh of one rank."""
    if mesh is None or mesh.world_size == 1:
        return x
    return _MeshSum.apply(x, mesh)


def mesh_sums(values: Sequence[torch.Tensor], mesh: Optional[Mesh]
              ) -> List[torch.Tensor]:
    """Each 0-d value summed over every rank of the mesh, all in one
    all-reduce (fp32), gradients passed through; the values themselves
    without a mesh or in a mesh of one rank."""
    if mesh is None or mesh.world_size == 1:
        return list(values)
    summed = mesh_sum(torch.stack([v.float() for v in values]), mesh)
    return list(summed.unbind(0))


# --------------------------------------------------------------------------
# Ulysses
# --------------------------------------------------------------------------

def _scatter_heads(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    b, h, s, d = x.shape
    u = mesh.ulysses_size
    chunks = x.reshape(b, u, h // u, s, d).transpose(0, 1)
    y = all_to_all(chunks, mesh)          # [U (seq chunk), B, H/U, S, D]
    return y.permute(1, 2, 0, 3, 4).reshape(b, h // u, u * s, d)


def _gather_heads(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    b, hl, sg, d = y.shape
    u = mesh.ulysses_size
    chunks = y.reshape(b, hl, u, sg // u, d).permute(2, 0, 1, 3, 4)
    z = all_to_all(chunks, mesh)          # [U (head chunk), B, H/U, S, D]
    return z.transpose(0, 1).reshape(b, hl * u, sg // u, d)


class _UlyssesExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, scatter):
        ctx.mesh, ctx.scatter = mesh, scatter
        return (_scatter_heads if scatter else _gather_heads)(x, mesh)

    @staticmethod
    def backward(ctx, g):
        inverse = _gather_heads if ctx.scatter else _scatter_heads
        return inverse(g, ctx.mesh), None, None


def ulysses_scatter_heads(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B, H, S_loc, D] → [B, H/U, S_loc·U, D] (heads scatter, sequence
    gather); differentiable."""
    if mesh.ulysses_size == 1:
        return x
    return _UlyssesExchange.apply(x, mesh, True)


def ulysses_gather_heads(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Inverse of :func:`ulysses_scatter_heads`; differentiable."""
    if mesh.ulysses_size == 1:
        return x
    return _UlyssesExchange.apply(x, mesh, False)


# --------------------------------------------------------------------------
# Ring
# --------------------------------------------------------------------------

class _RingLSEAttention(torch.autograd.Function):
    """(q, k0, v0 [BH, S_g, D], valid [BH, S_g] int32) → per-hop (out
    [R, BH, S_g, D] in q's dtype, lse [R, BH, S_g, 1] fp32). Hop h attends
    the chunk of ring rank ``(r - h) % R``."""

    @staticmethod
    def forward(ctx, q, k0, v0, valid, mesh):
        r, n = mesh.ring_rank, mesh.ring_size
        s_g = q.shape[1]
        k, v, vld = k0, v0, valid
        kvs, outs, lses = [], [], []
        for hop in range(n):
            src = (r - hop) % n
            out, lse = lse_attention_fwd(q, k, v, vld, r * s_g, src * s_g)
            kvs.append((k, v, vld))
            outs.append(out)
            lses.append(lse)
            if hop != n - 1:
                k, v, vld = ring_shift([k, v, vld], mesh)
        ctx.mesh = mesh
        ctx.valids = [x[2] for x in kvs]  # integer masks: no gradient
        ctx.save_for_backward(q, *[x[0] for x in kvs], *[x[1] for x in kvs],
                              *outs, *lses)
        return torch.stack(outs), torch.stack(lses)

    @staticmethod
    def backward(ctx, douts, dlses):
        mesh = ctx.mesh
        r, n = mesh.ring_rank, mesh.ring_size
        q, *saved = ctx.saved_tensors
        ks, vs = saved[:n], saved[n:2 * n]
        outs, lses = saved[2 * n:3 * n], saved[3 * n:]
        s_g = q.shape[1]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        acc = None
        for hop in range(n):
            src = (r - hop) % n
            dq_h, dk_h, dv_h = lse_attention_bwd(
                q, ks[hop], vs[hop], ctx.valids[hop], r * s_g, src * s_g,
                outs[hop], lses[hop], douts[hop], dlses[hop])
            dq += dq_h.float()
            # the accumulators travel with the chunk they belong to: at hop
            # h this rank holds chunk r - h and the sums of the ranks that
            # held it before; after the last hop one more shift reaches its
            # owner
            if acc is None:
                acc = [dk_h.float(), dv_h.float()]
            else:
                acc = [acc[0] + dk_h.float(), acc[1] + dv_h.float()]
            if n > 1:
                acc = ring_shift(acc, mesh)
        return (dq.to(q.dtype), acc[0].to(ks[0].dtype),
                acc[1].to(vs[0].dtype), None, None)


def ring_ttt_attention(
    mesh: Mesh,
    q: torch.Tensor,                        # [B, Hl, S_g, D] (post-Ulysses)
    k0: torch.Tensor,                       # step-0 keys, same shape
    v0: torch.Tensor,
    branch_keys: Sequence[torch.Tensor],    # each [B, Hl, S_g, D], diagonal
    branch_values: Sequence[torch.Tensor],
    key_valid: Optional[torch.Tensor],      # [B, S_g] validity of k0's chunk
) -> torch.Tensor:
    """Ring attention over the causal block, merged with the local TTT
    branches by log-sum-exp → [B, Hl, S_g, D] in q's dtype.

    Chunks are contiguous: ring rank r holds global positions
    ``[r·S_g, (r+1)·S_g)``. Every hop launches the LSE kernel, a later
    chunk's too (it writes out = 0, lse = -1e30), as the JAX package
    runs them all."""
    b, h, s_g, d = q.shape
    if key_valid is None:
        valid = torch.ones((b * h, s_g), dtype=torch.int32, device=q.device)
    else:
        valid = (key_valid != 0).to(torch.int32).repeat_interleave(
            h, dim=0).contiguous()

    def flat(x):
        return x.reshape(b * h, s_g, d).contiguous()

    outs, lses = _RingLSEAttention.apply(flat(q), flat(k0), flat(v0), valid,
                                         mesh)
    outs = [o.reshape(b, h, s_g, d).float() for o in outs.unbind(0)]
    lses = [x.reshape(b, h, s_g, 1) for x in lses.unbind(0)]
    # branch diagonal logits fold in as single-key attention sources
    q32 = q.float()
    scale = 1.0 / (d ** 0.5)
    for ki, vi in zip(branch_keys, branch_values):
        lses.append((q32 * ki.float()).sum(-1, keepdim=True) * scale)
        outs.append(vi.float().expand(q.shape))
    m = torch.cat(lses, dim=-1).max(dim=-1, keepdim=True).values
    m = torch.clamp(m, min=NEG_INF)  # all-masked rows stay finite
    weights = [torch.exp(x - m) for x in lses]
    numer = sum(o * w for o, w in zip(outs, weights))
    denom = sum(weights)
    return (numer / torch.clamp(denom, min=1e-30)).to(q.dtype)


def usp_ttt_attention_scattered(
    mesh: Mesh,
    q: torch.Tensor,                        # [B, Hl, S_g, D] (post-Ulysses)
    keys: Sequence[torch.Tensor],           # post-Ulysses, step 0 first
    values: Sequence[torch.Tensor],
    key_valid: Optional[torch.Tensor],      # [B, S_loc] (pre-exchange)
) -> torch.Tensor:
    """USP TTT attention of operands already through the Ulysses exchange
    (the draft keeps its branch cache that way, so each step's K/V cross
    once) → [B, S_loc, H·D]."""
    valid_g = None
    if key_valid is not None:
        # validity is per position: gather the sequence, no head scatter
        valid_g = (all_gather_seq(key_valid.to(torch.int32), mesh)
                   if mesh.ulysses_size > 1 else key_valid)
    out = ring_ttt_attention(mesh, q, keys[0], values[0], keys[1:],
                             values[1:], valid_g)
    out = ulysses_gather_heads(out, mesh)  # [B, H, S_loc, D]
    b, h, s_loc, d = out.shape
    return out.transpose(1, 2).reshape(b, s_loc, h * d)


def usp_ttt_attention_local(
    mesh: Mesh,
    q: torch.Tensor,                        # [B, H, S_loc, D] full heads
    keys: Sequence[torch.Tensor],           # per branch [B, H, S_loc, D]
    values: Sequence[torch.Tensor],
    key_valid: Optional[torch.Tensor] = None,  # [B, S_loc]
) -> torch.Tensor:
    """Full USP TTT attention for this rank's chunk → [B, S_loc, H·D].

    Heads must already be GQA-expanded to the full head count (the Ulysses
    exchange divides heads across ranks), as in the JAX package."""
    return usp_ttt_attention_scattered(
        mesh, ulysses_scatter_heads(q, mesh),
        [ulysses_scatter_heads(k, mesh) for k in keys],
        [ulysses_scatter_heads(v, mesh) for v in values], key_valid)


# --------------------------------------------------------------------------
# this rank's part of a global batch
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class SequenceShard:
    """This rank's sequence chunk of a global [B, S, ...] batch and the
    halo behind it.

    Rank chunk c (``mesh.chunk_index``) holds global positions
    ``[c·S_loc, (c+1)·S_loc)``. The TTT unroll shifts the ids and masks one
    position left per step and reads the teacher at ``p + idx``, so a rank
    also needs the ``halo = ttt_length - 1`` positions after its chunk.
    :meth:`take` cuts the global tensors to those ``real`` positions (on the
    host, before they move to the card); every other method works on such
    local tensors: :meth:`chunk` is the rank's own positions, :meth:`window`
    the chunk and its halo (``width = S_loc + halo``), zero past the global
    end as ``shift_pad`` fills. Without a mesh the shard is the whole
    sequence, with no halo, and :meth:`take` returns its input."""

    start: int
    size: int          # S_loc
    width: int         # S_loc + halo
    real: int          # positions of the window inside the sequence
    global_size: int   # S

    @classmethod
    def of(cls, mesh: Optional[Mesh], seq_len: int, halo: int
           ) -> "SequenceShard":
        if mesh is None or mesh.sp_size == 1:
            return cls(0, seq_len, seq_len, seq_len, seq_len)
        if seq_len % mesh.sp_size:
            raise ValueError(f"sequence length {seq_len} is not divisible by "
                             f"sp_ulysses*sp_ring={mesh.sp_size}")
        size = seq_len // mesh.sp_size
        start = mesh.chunk_index * size
        return cls(start, size, size + halo,
                   min(size + halo, seq_len - start), seq_len)

    def take(self, x: torch.Tensor, lookahead: int = 0) -> torch.Tensor:
        """Global [B, S, ...] → local [B, real (+ lookahead), ...]: the
        window's positions inside the sequence and up to ``lookahead`` more
        (for a shift left done after the cut), as a view."""
        stop = min(self.start + self.real + lookahead, self.global_size)
        if self.start == 0 and stop == x.shape[1]:
            return x
        return x[:, self.start:stop]

    def trim(self, x: torch.Tensor) -> torch.Tensor:
        """Local [B, n >= real, ...] → [B, real, ...]."""
        return x if x.shape[1] == self.real else x[:, :self.real]

    def chunk(self, x: torch.Tensor) -> torch.Tensor:
        """Local [B, real, ...] → this rank's [B, S_loc, ...]."""
        return x if x.shape[1] == self.size else x[:, :self.size]

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-pad ``x`` [B, n, ...] along the sequence to ``width``."""
        extra = self.width - x.shape[1]
        if extra == 0:
            return x
        return F.pad(x, [0, 0] * (x.dim() - 2) + [0, extra])

    def window(self, x: torch.Tensor) -> torch.Tensor:
        """Local [B, real, ...] → [B, width, ...]: the chunk and its
        halo."""
        return self.pad(x)
