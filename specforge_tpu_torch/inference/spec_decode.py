"""Speculative decoding with a trained draft: the serving-side loops.

Counterpart of ``specforge_tpu/inference/spec_decode.py`` in chain and
block mode: the EAGLE3 greedy chain decoder and the DFlash-family block
decoder (DFlash, Domino, DSpark), with KV-cached target forwards, which
measure the real accept lengths of a trained draft without an external
serving stack, and plain greedy decoding beside them.

Correctness invariant (tested): greedy speculative decoding emits exactly
the target's greedy sequence, for any draft; the draft changes the accept
length, never the output.

Static-shape design, as in the JAX package: caches are fixed
``[L, B, KVH, max_len, D]`` buffers, the cache length is a device tensor,
a block's K/V land with ``index_copy_`` at device indices, and attention
runs over the whole budget under a mask. Nothing in a forward reads a
device value on the host, so one round of a fused decoder is captured as
a CUDA graph where JAX compiled a ``lax.while_loop``: the host replays it
and reads one small status tensor a round. On the CPU the same round runs
eagerly. The target's attention over its cache is left to XLA in the JAX
package, and the port keeps it in plain torch (``ROADMAP.md`` Queue 2
item 6); the DFlash-family draft forward runs the hand-written DFlash
block-attention kernel with one anchor at the block's start.

Not here yet, refused by name: tree and beam speculation (``ROADMAP.md``
Queue 1 item 8c), batched and streamed decoding (item 8d), the P-EAGLE
decoder (item 8b) and sharded serving over a device mesh (item 8e).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from specforge_tpu_torch.models.target.transformer import (
    TargetConfig,
    _act,
    _linear,
    _rms,
)
from specforge_tpu_torch.ops.rope import (
    RopeSpec,
    apply_rope,
    rope_at,
    rope_table,
)
from specforge_tpu_torch.utils import DeviceLike, resolve_device

#: what the port does not serve yet, as its refusals name it
TREE_LATER = "tree and beam speculation come with ROADMAP.md Queue 1 item 8c"
BATCH_LATER = ("batched and streamed decoding come with ROADMAP.md Queue 1 "
               "item 8d")
PEAGLE_LATER = "P-EAGLE serving comes with ROADMAP.md Queue 1 item 8b"
SERVING_LATER = f"{TREE_LATER}; {BATCH_LATER}; {PEAGLE_LATER}"
MESH_LATER = ("sharded serving over a device mesh comes with ROADMAP.md "
              "Queue 1 item 8e")
#: the masked attention logit (JAX's fill)
NEG_INF = -1e30
#: eager runs of a step on a side stream before its CUDA graph is captured
WARMUP_RUNS = 3
#: stop token ids a fused request may name: its program reads them from a
#: buffer of this many slots, padded with -1, so every stop set shares one
#: program and one set of caches
STOP_SLOTS = 32


def check_dense_target(config: TargetConfig) -> None:
    """Serving takes dense targets, as the JAX package does: q/k/v
    projections, an optional qk_norm and a gated MLP in every layer."""
    cfg = config
    layers = range(cfg.num_hidden_layers)
    found = []
    if cfg.attn_variant != "standard":
        found.append(f"{cfg.attn_variant} attention")
    if any(cfg.is_moe_layer(i) for i in layers):
        found.append("MoE layers")
    kinds = sorted({cfg.layer_kind(i) for i in layers} - {"full_attention"})
    found += kinds
    for flag in ("sandwich_norms", "attention_sinks", "attn_output_gate",
                 "dual_sublayer", "qk_l2_norm", "embed_scale",
                 "attn_logit_softcapping", "query_pre_attn_scalar",
                 "no_rope_layers", "mrope_section"):
        if getattr(cfg, flag):
            found.append(flag)
    if cfg.norm_style != "standard":
        found.append(f"{cfg.norm_style} norms")
    if cfg.partial_rotary_factor != 1.0:
        found.append("partial rotary")
    if found:
        raise ValueError(
            "serving takes a dense target (q/k/v projections, an optional "
            f"qk_norm and a gated MLP); {cfg.model_type} has "
            + ", ".join(found))


# --------------------------------------------------------------------------
# cached target forward
# --------------------------------------------------------------------------

@dataclass
class TargetState:
    cache_k: torch.Tensor   # [L, B, KVH, M, D]
    cache_v: torch.Tensor
    length: int             # tokens already in the cache


def init_target_state(config: TargetConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: DeviceLike = None) -> TargetState:
    shape = (config.num_hidden_layers, batch, config.num_key_value_heads,
             max_len, config.resolved_head_dim)
    device = resolve_device(device)
    return TargetState(
        cache_k=torch.zeros(shape, dtype=dtype, device=device),
        cache_v=torch.zeros(shape, dtype=dtype, device=device), length=0)


def _scatter_cache_rows(cache: torch.Tensor, new: torch.Tensor,
                        starts: torch.Tensor) -> None:
    """Per-row cache write, in place: ``cache[b, :, starts[b] + j] =
    new[b, :, j]`` for cache [B, KVH, M, D], new [B, KVH, T, D], starts [B]
    (rows at different lengths); writes past M are dropped, as JAX's
    ``mode="drop"`` drops them."""
    b, kvh, m, d = cache.shape
    t = new.shape[2]
    slots = starts[:, None] + torch.arange(t, device=cache.device)
    # dropped writes land in a spare slot past the cache
    slots = torch.where((slots >= 0) & (slots < m), slots, m)
    ext = torch.cat([cache, cache.new_zeros(b, kvh, 1, d)], dim=2)
    rows = torch.arange(b, device=cache.device)[:, None]
    # advanced indices at dims 0 and 2, split by a slice: the [B, T] index
    # axes come first in the indexed view
    ext[rows, :, slots] = new.transpose(1, 2).to(cache.dtype)
    cache.copy_(ext[:, :, :m])


def _write_block(cache: torch.Tensor, new: torch.Tensor,
                 cache_len: torch.Tensor) -> None:
    """``new`` [B, KVH, T, D] into ``cache`` [B, KVH, M, D] from slot
    ``cache_len``: a device scalar (the start clamped to M - T, as
    ``dynamic_update_slice`` clamps it) or per-row lengths [B]."""
    if cache_len.dim() == 1:
        _scatter_cache_rows(cache, new, cache_len)
        return
    t, m = new.shape[2], cache.shape[2]
    start = cache_len.clamp(0, m - t)
    cache.index_copy_(2, start + torch.arange(t, device=cache.device),
                      new.to(cache.dtype))


def _causal_allow(cache_len: torch.Tensor, t: int, m: int) -> torch.Tensor:
    """Causal visibility of the cache slots: slot < cache_len + row + 1;
    [T, M] for a scalar length, [B, T, M] for per-row lengths."""
    device = cache_len.device
    col = torch.arange(m, device=device)[None, :]
    row_pos = torch.arange(t, device=device)[:, None]
    if cache_len.dim() == 1:
        return col[None] <= cache_len[:, None, None] + row_pos[None]
    return col <= cache_len + row_pos


def _attend_cache(q: torch.Tensor, cache_k: torch.Tensor,
                  cache_v: torch.Tensor, allow: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Grouped-query attention of q [B, H, T, D] over the whole cache
    [B, KVH, M, D] under ``allow`` ([T, M] or [B, T, M]) → [B, T, H·D].
    JAX's einsums: scores are fp32 sums of products in q's dtype, divided
    by sqrt(D), masked with -1e30; the probabilities cast to ``out_dtype``
    meet V in that dtype."""
    b, h, t, d = q.shape
    kvh = cache_k.shape[1]
    qg = q.reshape(b, kvh, h // kvh, t, d)
    keys = cache_k.to(q.dtype).float()[:, :, None]
    w = torch.matmul(qg.float(), keys.transpose(-1, -2)) / (d ** 0.5)
    allow_b = (allow[None, None, None] if allow.dim() == 2
               else allow[:, None, None])
    w = w.masked_fill(~allow_b, NEG_INF)
    p = torch.softmax(w, dim=-1).to(out_dtype)
    attn = torch.matmul(p, cache_v.to(out_dtype)[:, :, None])
    return attn.reshape(b, h, t, d).transpose(1, 2).reshape(b, t, h * d)


@torch.no_grad()
def target_cached_forward(
    params: Dict[str, torch.Tensor],
    config: TargetConfig,
    input_ids: torch.Tensor,     # [B, T] block
    cache_k: torch.Tensor,       # [L, B, KVH, M, D]
    cache_v: torch.Tensor,
    cache_len,                   # scalar, or [B] per-row lengths
    capture_layers: Sequence[int],
    block_allow: Optional[torch.Tensor] = None,      # [T, T] or [B, T, T]
    block_positions: Optional[torch.Tensor] = None,  # [T] logical depths
    prefix_valid: Optional[torch.Tensor] = None,     # [B, M] pad mask
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Decode or prefill one block against the cache.

    ``block_allow``/``block_positions`` verify a TREE: the block holds tree
    nodes in slot order; node i attends the whole prefix plus the block
    slots ``block_allow[i]`` (its ancestors), at the RoPE position
    ``cache_len + block_positions[i]`` (its depth). Default: causal.

    Batched serving: ``cache_len`` may be a [B] vector (rows at different
    lengths; K/V land by a per-row scatter) and ``prefix_valid`` masks
    left-pad slots out of attention.

    ``rope``: ``rope_table``'s cos/sin for the cache, else computed here.
    The block's K/V are written into ``cache_k``/``cache_v`` in place.
    Returns (logits [B, T, V], aux [B, T, L·H], cache_k, cache_v).
    """
    cfg = config
    device = cache_k.device
    input_ids = torch.as_tensor(input_ids, device=device).long()
    b, t = input_ids.shape
    d = cfg.resolved_head_dim
    h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    m = cache_k.shape[3]
    if t > m:
        raise ValueError(f"a block of {t} tokens does not fit a cache of {m}")
    capture_set = set(int(c) for c in capture_layers)
    cache_len = torch.as_tensor(cache_len, device=device).long()
    per_row = cache_len.dim() == 1
    len_col = cache_len[:, None] if per_row else cache_len

    depths = (torch.arange(t, device=device) if block_positions is None
              else torch.as_tensor(block_positions, device=device).long())
    positions = (len_col + depths[None]).expand(b, t)
    cos, sin = rope_at(RopeSpec.from_config(cfg), positions, m,
                       torch.bfloat16, rope)

    x = params["model.embed_tokens.weight"][input_ids]
    if block_allow is None:
        allow = _causal_allow(cache_len, t, m)
    else:
        block_allow = torch.as_tensor(block_allow, device=device).bool()
        col = torch.arange(m, device=device)[None, :]
        if per_row:
            # row b's block occupies slots cache_len[b] .. cache_len[b]+t-1
            prefix_vis = col < cache_len[:, None]                # [B, M]
            in_block = (col >= cache_len[:, None]) & (
                col < cache_len[:, None] + t)
            bidx = (col - cache_len[:, None]).clamp(0, t - 1)    # [B, M]
            if block_allow.dim() == 3:   # per-row trees [B, T, T]
                blk_vis = torch.gather(
                    block_allow, 2, bidx[:, None, :].expand(b, t, m))
            else:
                blk_vis = block_allow[:, bidx].permute(1, 0, 2)  # [B, T, M]
            allow = prefix_vis[:, None, :] | (in_block[:, None, :] & blk_vis)
        else:
            prefix_vis = col < cache_len                         # [1, M]
            in_block = (col >= cache_len) & (col < cache_len + t)
            bidx = (col[0] - cache_len).clamp(0, t - 1)          # [M]
            allow = prefix_vis | (in_block & block_allow[:, bidx])
    if prefix_valid is not None:
        prefix_valid = torch.as_tensor(prefix_valid, device=device).bool()
        allow = (allow[None] if allow.dim() == 2 else allow) & (
            prefix_valid[:, None, :])

    captured = {}
    eps = cfg.rms_norm_eps
    for i in range(cfg.num_hidden_layers):
        prefix = f"model.layers.{i}"
        ap = f"{prefix}.self_attn"
        residual = x
        y = _rms(x, params[f"{prefix}.input_layernorm.weight"], eps)
        q = _linear(params, f"{ap}.q_proj", y).reshape(b, t, h, d)
        k = _linear(params, f"{ap}.k_proj", y).reshape(b, t, kvh, d)
        v = _linear(params, f"{ap}.v_proj", y).reshape(b, t, kvh, d)
        if cfg.qk_norm:
            q = _rms(q, params[f"{ap}.q_norm.weight"], eps)
            k = _rms(k, params[f"{ap}.k_norm.weight"], eps)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        q, k = apply_rope(q, k, cos, sin)
        _write_block(cache_k[i], k, cache_len)
        _write_block(cache_v[i], v, cache_len)
        attn = _attend_cache(q, cache_k[i], cache_v[i], allow, x.dtype)
        x = residual + attn @ params[f"{ap}.o_proj.weight"].to(x.dtype).T

        residual = x
        y = _rms(x, params[f"{prefix}.post_attention_layernorm.weight"], eps)
        gate = y @ params[f"{prefix}.mlp.gate_proj.weight"].to(y.dtype).T
        up = y @ params[f"{prefix}.mlp.up_proj.weight"].to(y.dtype).T
        x = residual + (_act(cfg.hidden_act)(gate) * up) @ params[
            f"{prefix}.mlp.down_proj.weight"].to(y.dtype).T
        if i in capture_set:
            captured[i] = x

    last = _rms(x, params["model.norm.weight"], eps)
    logits = last @ params["lm_head.weight"].to(last.dtype).T
    # plain decoding passes no capture layers: a zero-width aux
    aux = (torch.cat([captured[int(i)] for i in capture_layers], dim=-1)
           if capture_layers else x.new_zeros(b, t, 0))
    return logits, aux, cache_k, cache_v


# --------------------------------------------------------------------------
# cached EAGLE3 draft forward
# --------------------------------------------------------------------------

@dataclass
class DraftState:
    cache_k: torch.Tensor   # [B, KVH, M, D]
    cache_v: torch.Tensor
    length: int


def init_draft_state(draft_config, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None) -> DraftState:
    shape = (batch, draft_config.num_key_value_heads, max_len,
             draft_config.resolved_head_dim)
    device = resolve_device(device)
    return DraftState(
        cache_k=torch.zeros(shape, dtype=dtype, device=device),
        cache_v=torch.zeros(shape, dtype=dtype, device=device), length=0)


@torch.no_grad()
def _draft_step(draft, input_ids, hidden, cache_k, cache_v, cache_len,
                prefix_valid=None, rope=None):
    """One cached step of an EAGLE3 draft (``LlamaEagle3Draft``): [B, T]
    tokens and [B, T, h] hidden features → (next hidden [B, T, h], logits
    [B, T, Vd], caches), the K/V written into the caches in place.

    Serving attention is plain causal over the accumulated cache: the TTT
    branches are a training construct. ``cache_len`` may be a [B] vector
    and ``prefix_valid`` a [B, M] pad mask, and ``rope`` a table, as for
    ``target_cached_forward``."""
    cfg = draft.config
    device = cache_k.device
    input_ids = torch.as_tensor(input_ids, device=device).long()
    b, t = input_ids.shape
    d = cfg.resolved_head_dim
    h_heads, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    m = cache_k.shape[2]
    clen = torch.as_tensor(cache_len, device=device).long()
    len_col = clen[:, None] if clen.dim() == 1 else clen

    embeds = draft.embed_input_ids(input_ids).to(hidden.dtype)
    layer = draft.midlayer
    residual = hidden
    x2 = torch.cat([layer.input_layernorm(embeds), layer.hidden_norm(hidden)],
                   dim=-1)
    attn = layer.self_attn
    qc, kc = h_heads * d, kvh * d
    qkv = attn.qkv_proj(x2)
    q = qkv[..., :qc].reshape(b, t, h_heads, d).transpose(1, 2)
    k = qkv[..., qc:qc + kc].reshape(b, t, kvh, d).transpose(1, 2)
    v = qkv[..., qc + kc:].reshape(b, t, kvh, d).transpose(1, 2)
    positions = (len_col + torch.arange(t, device=device)[None]).expand(b, t)
    cos, sin = rope_at(attn.rope_spec, positions, m, q.dtype, rope)
    q, k = apply_rope(q, k, cos, sin)
    _write_block(cache_k, k, clen)
    _write_block(cache_v, v, clen)
    allow = _causal_allow(clen, t, m)
    if prefix_valid is not None:
        prefix_valid = torch.as_tensor(prefix_valid, device=device).bool()
        allow = (allow[None] if allow.dim() == 2 else allow) & (
            prefix_valid[:, None, :])
    out = _attend_cache(q, cache_k, cache_v, allow, q.dtype)
    x = residual + attn.o_proj(out)
    x = x + layer.mlp(layer.post_attention_layernorm(x))
    return x, draft.compute_logits(x), cache_k, cache_v


# --------------------------------------------------------------------------
# steps captured as CUDA graphs
# --------------------------------------------------------------------------

class _Program:
    """One fused decode step over static buffers. On a CUDA device the step
    is captured once as a CUDA graph (after ``WARMUP_RUNS`` eager runs on a
    side stream, while the buffers hold no request) and every call replays
    it, adding one to ``counter.replays``; a failed capture raises, since
    the card never falls back to eager steps. On the CPU each call runs the
    step eagerly."""

    def __init__(self, step: Callable[[], None], device: torch.device,
                 counter: Any):
        self.step = step
        self.counter = counter
        self.graph = None
        if device.type == "cuda":
            self.graph = self._capture(step)

    @staticmethod
    @torch.no_grad()
    def _capture(step):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                step()
        except RuntimeError as exc:
            raise RuntimeError(
                "CUDA graph capture of a fused decode step failed") from exc
        return graph

    @torch.no_grad()
    def __call__(self) -> None:
        if self.graph is None:
            self.step()
            return
        self.graph.replay()
        self.counter.replays += 1


def _stop_ids(stop_token_ids: Optional[Sequence[int]]) -> Tuple[int, ...]:
    """A fused request's stop set, at most ``STOP_SLOTS`` ids."""
    stop_ids = tuple(sorted(set(int(s) for s in (stop_token_ids or ()))))
    if len(stop_ids) > STOP_SLOTS:
        raise ValueError(f"{len(stop_ids)} stop token ids: a fused decode "
                         f"takes at most {STOP_SLOTS}")
    return stop_ids


def _fill_stop(buffer: torch.Tensor, stop_ids: Tuple[int, ...]) -> None:
    """The stop set into a program's ``STOP_SLOTS`` buffer, padded with -1
    (no token's id)."""
    buffer.fill_(-1)
    if stop_ids:
        buffer[:len(stop_ids)].copy_(torch.tensor(stop_ids, dtype=torch.long))


def _fused_stop_hit(emitted: torch.Tensor, valid: torch.Tensor,
                    stop: torch.Tensor) -> torch.Tensor:
    """Any ACCEPTED emitted token in the stop buffer?"""
    hits = (emitted[:, None] == stop[None, :]).any(dim=-1)
    return (hits & valid).any()


def _scalar(value: int, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.long, device=device)


# --------------------------------------------------------------------------
# the speculative decoding loop
# --------------------------------------------------------------------------

@dataclass
class SpecDecodeResult:
    output_ids: np.ndarray          # [total_len] prompt + generated
    accept_lengths: List[int]       # accepted per round (incl. bonus token)
    steps: int

    @property
    def mean_accept_length(self) -> float:
        if not self.accept_lengths:
            return 0.0
        return float(np.mean(self.accept_lengths))


class Eagle3SpecDecoder:
    """Greedy chain speculative decoding (batch 1).

    ``draft`` is a ``LlamaEagle3Draft`` holding its weights. The target's
    weights and the draft are moved to ``device`` once, at construction
    (CUDA unless the caller names another device)."""

    def __init__(
        self,
        target_params: Dict[str, torch.Tensor],
        target_config: TargetConfig,
        draft,
        capture_layers: Sequence[int],
        *,
        num_draft_tokens: int = 4,
        max_len: int = 512,
        mesh=None,
        device: DeviceLike = None,
    ) -> None:
        if mesh is not None:
            raise ValueError(MESH_LATER)
        check_dense_target(target_config)
        self.device = resolve_device(device)
        self.target_params = {name: value.to(self.device)
                              for name, value in target_params.items()}
        self.target_config = target_config
        self.draft = draft.to(self.device)
        self.capture_layers = tuple(capture_layers)
        self.k = num_draft_tokens
        self.max_len = max_len
        self._d2t = self._resolve_d2t(draft)
        self._d2t_device = torch.as_tensor(self._d2t, device=self.device)
        # cos/sin over the cache budget, the target's and the draft's,
        # shared by every forward of this decoder
        self._t_rope = rope_table(RopeSpec.from_config(target_config),
                                  max_len, torch.bfloat16, self.device)
        self._d_rope = rope_table(self.draft.midlayer.self_attn.rope_spec,
                                  max_len, self.draft.dtype, self.device)
        self._fused = _FusedEagleLoops(self)
        #: ``fused_plain_decode``'s programs for this target (the server's
        #: plain mode)
        self.plain_loops: Dict[Any, Any] = {}

    @staticmethod
    def _resolve_d2t(draft) -> np.ndarray:
        d2t = getattr(draft, "d2t", None)
        if d2t is None:
            raise KeyError("draft carries no d2t buffer")
        return d2t.detach().cpu().numpy().astype(np.int64)

    def _check_prompt(self, p_len: int) -> None:
        if p_len > self.max_len:
            raise ValueError(f"a prompt of {p_len} tokens does not fit "
                             f"max_len={self.max_len}")

    def _target_forward(self, ids: np.ndarray, state: TargetState):
        logits, aux, ck, cv = target_cached_forward(
            self.target_params, self.target_config,
            torch.as_tensor(ids, device=self.device), state.cache_k,
            state.cache_v, state.length, self.capture_layers,
            rope=self._t_rope)
        new_state = TargetState(cache_k=ck, cache_v=cv,
                                length=state.length + ids.shape[1])
        return logits, aux, new_state

    def _step(self, ids, hidden, ck, cv, clen):
        ids = torch.as_tensor(ids, device=self.device)
        return _draft_step(self.draft, ids, hidden, ck, cv, clen,
                           rope=self._d_rope)

    def _chain_from(self, first_draft_idx: int, hidden, ck, cv, clen: int):
        """Greedy draft chain of length ``k`` from a draft-vocab token, on
        the pre-round caches. Chain steps pair (previous proposal, the
        draft's own hidden), as later TTT steps do in training. The steps'
        cache writes past the round's start are overwritten by the
        re-extension before anything attends them."""
        d2t = self._d2t
        proposals = [first_draft_idx + int(d2t[first_draft_idx])]
        for _ in range(self.k - 1):
            hidden, dlogits, ck, cv = self._step(
                [[proposals[-1]]], hidden, ck, cv, clen)
            clen += 1
            dt = int(dlogits[0, -1].argmax())
            proposals.append(dt + int(d2t[dt]))
        return proposals

    @torch.no_grad()
    def _prefill_device(self, prompt: np.ndarray, t_ck, t_cv, d_ck, d_cv):
        """Prefill for the fused path into the given caches (zeroed
        first), everything on the device → (the first token, the draft's
        last hidden [1, 1, h] and logits [1, Vd])."""
        for cache in (t_ck, t_cv, d_ck, d_cv):
            cache.zero_()
        ids = torch.as_tensor(prompt, device=self.device)
        logits, aux, _, _ = target_cached_forward(
            self.target_params, self.target_config, ids, t_ck, t_cv, 0,
            self.capture_layers, rope=self._t_rope)
        cur = logits[0, -1].argmax()
        draft_hidden = self.draft.project_hidden_states(aux)
        shifted = torch.cat([ids[0, 1:], cur.view(1)])[None]
        next_hidden, dlogits, _, _ = self._step(
            shifted, draft_hidden, d_ck, d_cv, 0)
        return cur, next_hidden[:, -1:], dlogits[:, -1]

    @torch.no_grad()
    def _prefill(self, prompt_ids, prompt: np.ndarray, budget: int):
        """Target prefill and the EAGLE draft bootstrap: the draft reads
        teacher-shifted pairs (token_{i+1}, feature_i) over the prompt; its
        final logits already predict the next round's first proposal."""
        p_len = prompt.shape[1]
        t_state = init_target_state(self.target_config, 1, budget,
                                    device=self.device)
        d_state = init_draft_state(self.draft.config, 1, budget,
                                   device=self.device)
        logits, aux, t_state = self._target_forward(prompt, t_state)
        cur_token = int(logits[0, -1].argmax())
        output = list(prompt_ids) + [cur_token]
        draft_hidden = self.draft.project_hidden_states(aux)
        shifted_ids = np.concatenate([prompt[0, 1:], [cur_token]])[None]
        next_hidden, dlogits, ck, cv = self._step(
            shifted_ids, draft_hidden, d_state.cache_k, d_state.cache_v, 0)
        d_state = DraftState(cache_k=ck, cache_v=cv, length=p_len)
        return (output, cur_token, t_state, d_state, next_hidden[:, -1:],
                dlogits[:, -1])

    @torch.no_grad()
    def generate(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int,
        stop_token_ids: Optional[Sequence[int]] = None,
        topk: int = 1,
    ) -> SpecDecodeResult:
        """The host loop: the oracle the fused path is held to."""
        if topk > 1:
            raise ValueError(f"topk={topk}: {TREE_LATER}")
        stop = set(stop_token_ids or ())
        prompt = np.asarray(prompt_ids, np.int64)[None]  # [1, P]
        p_len = prompt.shape[1]
        budget = self.max_len
        self._check_prompt(p_len)

        (output, cur_token, t_state, d_state, last_hidden,
         last_dlogits) = self._prefill(prompt_ids, prompt, budget)

        accept_lengths: List[int] = []
        steps = 0
        while (len(output) - p_len < max_new_tokens
               and t_state.length + self.k + 1 < budget):
            steps += 1
            # --- draft chain proposal ---
            proposals = self._chain_from(
                int(last_dlogits[0].argmax()), last_hidden,
                d_state.cache_k, d_state.cache_v, d_state.length)

            # --- target verification over [cur, d1..dk] ---
            block = np.asarray([[cur_token, *proposals]], np.int64)
            logits, aux, t_state = self._target_forward(block, t_state)
            posterior = logits[0].argmax(dim=-1).tolist()  # [k+1]
            accepted = 0
            for j in range(self.k):
                if proposals[j] == posterior[j]:
                    accepted += 1
                else:
                    break
            emitted = [*proposals[:accepted], posterior[accepted]]
            output.extend(emitted)
            accept_lengths.append(accepted + 1)

            # --- roll caches back to the accepted prefix ---
            # target: the block wrote k+1 entries; keep accepted+1 of them
            t_state = TargetState(
                cache_k=t_state.cache_k, cache_v=t_state.cache_v,
                length=t_state.length - (self.k + 1) + accepted + 1)
            # draft: re-extend over the accepted block with target features
            draft_hidden = self.draft.project_hidden_states(
                aux[:, : accepted + 1])
            next_hidden, dlogits, ck, cv = self._step(
                [emitted], draft_hidden, d_state.cache_k, d_state.cache_v,
                d_state.length)
            d_state = DraftState(cache_k=ck, cache_v=cv,
                                 length=d_state.length + accepted + 1)
            last_hidden = next_hidden[:, -1:]
            last_dlogits = dlogits[:, -1]
            cur_token = posterior[accepted]

            if stop & set(emitted):
                break
        return SpecDecodeResult(output_ids=np.asarray(output),
                                accept_lengths=accept_lengths, steps=steps)

    @torch.no_grad()
    def generate_fused(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int,
        stop_token_ids: Optional[Sequence[int]] = None,
        topk: int = 1,
        tree_style: str = "root",
    ) -> SpecDecodeResult:
        """``generate`` with each round fused into one program: on the card
        a CUDA graph replayed once a round (the draft chain, the
        verification, acceptance, the buffers' writes and the draft
        re-extension), with one small status read a round where the host
        loop syncs ~k+3 times. The same tokens and accept lengths as
        ``generate`` (tested)."""
        if topk > 1 or tree_style != "root":
            raise ValueError(f"topk={topk}, tree_style={tree_style!r}: "
                             f"{TREE_LATER}")
        stop_ids = _stop_ids(stop_token_ids)
        prompt = np.asarray(prompt_ids, np.int64)[None]
        p_len = prompt.shape[1]
        budget = self.max_len
        self._check_prompt(p_len)

        program, s = self._fused.chain(budget)
        _fill_stop(s.stop, stop_ids)
        cur, last_hidden, last_dlogits = self._prefill_device(
            prompt, s.t_ck, s.t_cv, s.d_ck, s.d_cv)
        for name in ("t_len", "d_len"):
            getattr(s, name).fill_(p_len)
        s.cur.copy_(cur)
        s.last_h.copy_(last_hidden)
        s.last_dl.copy_(last_dlogits)
        s.out_buf.zero_()
        s.out_buf[:1].copy_(cur.view(1))
        s.out_cnt.fill_(1)
        s.acc_buf.zero_()
        s.n_rounds.zero_()
        s.done.zero_()
        s.max_new.fill_(max_new_tokens)
        go = 1 < max_new_tokens and p_len + self.k + 1 < budget
        while go:
            program()
            go = bool(s.status[0])
        out_cnt, n_rounds = int(s.out_cnt), int(s.n_rounds)
        output = np.concatenate([np.asarray(prompt_ids, np.int64),
                                 s.out_buf[:out_cnt].cpu().numpy()])
        return SpecDecodeResult(
            output_ids=output,
            accept_lengths=s.acc_buf[:n_rounds].cpu().tolist(),
            steps=n_rounds)

    def generate_batch_fused(self, *args, **kwargs):
        raise ValueError(f"generate_batch_fused: {BATCH_LATER}")

    def generate_stream_fused(self, *args, **kwargs):
        raise ValueError(f"generate_stream_fused: {BATCH_LATER}")


class _FusedEagleLoops:
    """Fused chain rounds for one ``Eagle3SpecDecoder``: one program (a
    CUDA graph on the card) per cache budget, where JAX compiles one loop
    per (stop set, shapes): the stop set is data in the program's buffer,
    so requests with any stop set and prompts of any length reuse it (the
    prefill runs eagerly, as JAX's is a program of its own). ``replays``
    counts graph replays."""

    def __init__(self, decoder: Eagle3SpecDecoder):
        self.decoder = decoder
        self._cache: Dict[Any, Tuple[_Program, SimpleNamespace]] = {}
        self.replays = 0

    def chain(self, budget: int) -> Tuple[_Program, SimpleNamespace]:
        key = ("chain", budget)
        if key not in self._cache:
            s = self._chain_state(budget)
            program = _Program(functools.partial(self._chain_round, s),
                               self.decoder.device, self)
            self._cache[key] = (program, s)
        return self._cache[key]

    def _chain_state(self, budget: int) -> SimpleNamespace:
        d = self.decoder
        dev, k = d.device, d.k
        cfg = d.draft.config
        s = SimpleNamespace()  # the program's static buffers
        t_state = init_target_state(d.target_config, 1, budget, device=dev)
        d_state = init_draft_state(cfg, 1, budget, device=dev)
        s.t_ck, s.t_cv = t_state.cache_k, t_state.cache_v
        s.d_ck, s.d_cv = d_state.cache_k, d_state.cache_v
        for name in ("t_len", "d_len", "cur", "out_cnt", "n_rounds",
                     "max_new"):
            setattr(s, name, _scalar(0, dev))
        s.done = torch.zeros((), dtype=torch.bool, device=dev)
        s.last_h = torch.zeros(1, 1, cfg.hidden_size, dtype=d.draft.dtype,
                               device=dev)
        s.last_dl = torch.zeros(1, cfg.draft_vocab_size, dtype=d.draft.dtype,
                                device=dev)
        s.out_buf = torch.zeros(budget + k + 1, dtype=torch.long, device=dev)
        s.acc_buf = torch.zeros(budget, dtype=torch.long, device=dev)
        s.idx = torch.arange(k + 1, device=dev)
        s.stop = torch.full((STOP_SLOTS,), -1, dtype=torch.long, device=dev)
        s.status = torch.zeros(3, dtype=torch.long, device=dev)
        return s

    def _chain_propose(self, first_dlogits, hidden, d_ck, d_cv, d_len):
        """k greedy chain proposals, all on the device."""
        d = self.decoder
        d2t = d._d2t_device
        p = first_dlogits[0].argmax().view(1)
        toks = [p + d2t.index_select(0, p)]
        h, clen = hidden, d_len
        for _ in range(d.k - 1):
            h, dlog, _, _ = d._step(toks[-1].view(1, 1), h, d_ck, d_cv,
                                    clen)
            clen = clen + 1
            dt = dlog[0, -1].argmax().view(1)
            toks.append(dt + d2t.index_select(0, dt))
        return torch.cat(toks)  # [k] target-vocab

    def _chain_round(self, s: SimpleNamespace) -> None:
        """One chain round over the static buffers (JAX's loop body), then
        the loop condition into ``s.status``: (go on, output count,
        rounds)."""
        d = self.decoder
        k = d.k
        proposals = self._chain_propose(s.last_dl, s.last_h, s.d_ck, s.d_cv,
                                        s.d_len)
        block = torch.cat([s.cur.view(1), proposals])[None]
        logits, aux, _, _ = target_cached_forward(
            d.target_params, d.target_config, block, s.t_ck, s.t_cv, s.t_len,
            d.capture_layers, rope=d._t_rope)
        posterior = logits[0].argmax(dim=-1)
        matches = (proposals == posterior[:k]).long()
        acc = torch.cumprod(matches, dim=0).sum()
        bonus = posterior.index_select(0, acc.view(1))
        emitted = torch.where(s.idx < acc, torch.cat([proposals, bonus]),
                              bonus)                                # [k+1]
        start = s.out_cnt.clamp(max=s.out_buf.shape[0] - (k + 1))
        s.out_buf.index_copy_(0, start + s.idx, emitted)
        s.acc_buf.index_copy_(
            0, s.n_rounds.clamp(max=s.acc_buf.shape[0] - 1).view(1),
            (acc + 1).view(1))

        # draft re-extension over the whole block: the slots past acc hold
        # garbage, overwritten by the next round before anything attends
        # them
        hidden_full = d.draft.project_hidden_states(aux)
        h_out, dlog_out, _, _ = d._step(emitted[None], hidden_full, s.d_ck,
                                        s.d_cv, s.d_len)
        s.last_h.copy_(h_out.index_select(1, acc.view(1)))
        s.last_dl.copy_(dlog_out.index_select(1, acc.view(1))[:, 0])
        s.done.copy_(_fused_stop_hit(emitted, s.idx <= acc, s.stop))
        s.t_len.add_(acc + 1)
        s.d_len.add_(acc + 1)
        s.cur.copy_(bonus[0])
        s.out_cnt.add_(acc + 1)
        s.n_rounds.add_(1)
        go = (~s.done) & (s.out_cnt < s.max_new) & (
            s.t_len + k + 1 < s.t_ck.shape[3])
        s.status.copy_(torch.stack([go.long(), s.out_cnt, s.n_rounds]))


# --------------------------------------------------------------------------
# DFlash-family block speculative decoding
# --------------------------------------------------------------------------

class DFlashSpecDecoder:
    """Block speculative decoding with a DFlash-family draft (greedy,
    batch 1): the draft predicts a whole block of ``block_size - 1`` tokens
    in one forward (mask tokens attending to the target's captured
    features), the target verifies the block, and the accepted prefix's
    fresh features extend the context.

    ``draft`` is a ``DFlashDraftModel``, ``DominoDraftModel`` or
    ``DSparkDraftModel`` holding its weights; its forward runs the
    training-time anchor-block attention with a single anchor at the block
    start (on the card the DFlash kernel), so serving runs the trained code
    path. The target's weights and the draft are moved to ``device`` once,
    at construction (CUDA unless the caller names another device), with an
    fp32 copy of the target's head for the proposals' fp32 logits (JAX's
    ``einsum`` over the upcast head), made once."""

    def __init__(
        self,
        target_params: Dict[str, torch.Tensor],
        target_config: TargetConfig,
        draft,
        *,
        max_len: int = 512,
        mesh=None,
        device: DeviceLike = None,
    ) -> None:
        if mesh is not None:
            raise ValueError(MESH_LATER)
        check_dense_target(target_config)
        self.device = resolve_device(device)
        self.target_params = {name: value.to(self.device)
                              for name, value in target_params.items()}
        self.target_config = target_config
        self.draft = draft.to(self.device)
        cfg = draft.config
        self.capture_layers = tuple(cfg.resolved_target_layer_ids)
        self.block_size = cfg.block_size
        self.mask_token_id = cfg.mask_token_id or 0
        self.max_len = max_len
        self._projector = cfg.projector_type or "dflash"
        self._shift = bool(cfg.shift_label)
        self._embed = self.target_params["model.embed_tokens.weight"]
        self._lm_head = self.target_params["lm_head.weight"].float()
        self._idx = torch.arange(self.block_size, device=self.device)
        self._keep = torch.ones((1, 1), dtype=torch.bool, device=self.device)
        # cos/sin over the cache budget: the target's, and the draft's at
        # the context's and the block's lengths, shared by every forward
        self._t_rope = rope_table(RopeSpec.from_config(target_config),
                                  max_len, torch.bfloat16, self.device)
        spec = self.draft.layers[0].self_attn.rope_spec
        self._d_rope = (
            rope_table(spec, max_len, draft.dtype, self.device),
            rope_table(spec, max_len, draft.dtype, self.device,
                       seq_len=self.block_size))
        self._fused = _FusedDFlashLoops(self)
        #: ``fused_plain_decode``'s programs for this target (the server's
        #: plain mode)
        self.plain_loops: Dict[Any, Any] = {}

    def _check_prompt(self, p_len: int) -> None:
        if p_len > self.max_len:
            raise ValueError(f"a prompt of {p_len} tokens does not fit "
                             f"max_len={self.max_len}")

    def _draft_forward(self, cur: torch.Tensor, ctx: torch.Tensor,
                       start) -> torch.Tensor:
        """One block forward: the block [cur, mask, ...] at positions
        start .., the context ``ctx`` [1, S, n_capture·h] at 0 .. S - 1 and
        one anchor at ``start`` → the draft's hidden states [1, bs, h]. The
        noise embeddings and the context are cast to bf16, as JAX casts
        them."""
        block = torch.where(self._idx == 0, cur, self.mask_token_id)
        noise = self._embed[block].float()[None].to(torch.bfloat16)
        s = ctx.shape[1]
        ctx_pos = torch.arange(s, device=self.device)[None]
        start = torch.as_tensor(start, device=self.device).long()
        return self.draft(noise, ctx.to(torch.bfloat16), ctx_pos,
                          (start + self._idx)[None], start.view(1, 1),
                          self._keep, rope=self._d_rope)

    def _propose(self, draft_hidden: torch.Tensor,
                 cur: torch.Tensor) -> torch.Tensor:
        """Greedy block proposals [bs - 1], on the device, with the
        family's logits head applied causally within the block: Domino feeds
        its GRU the embeddings of the tokens already committed, DSpark its
        Markov head the previous sampled id, each ``bs - 1`` times; plain
        DFlash takes one argmax, position j predicting token j + 1 under
        ``shift_label``."""
        bs = self.block_size
        base = torch.nn.functional.linear(draft_hidden.float(),
                                          self._lm_head)     # [1, bs, V]
        if self._projector == "dflash":
            sel = base[0, :-1] if self._shift else base[0, 1:]
            return sel.argmax(dim=-1)
        hidden4, base4 = draft_hidden[:, None], base[:, None]
        if self._projector == "domino":
            completed = torch.where(self._idx == 0, cur, self.mask_token_id)
            for pos in range(1, bs):
                prev = self._embed[completed].float()[None, None]
                final = self.draft.apply_logits_head(
                    base4, prev_token_embeddings=prev, hidden_states=hidden4)
                head_pos = pos - 1 if self._shift else pos
                completed = torch.where(self._idx == pos,
                                        final[0, 0, head_pos].argmax(),
                                        completed)
            return completed[1:]
        # DSpark is shift-labelled: position p predicts the token after the
        # one at p, given that one as its previous id; the heads are causal
        # in the previous ids, so refilling them one by one is exact
        prev = torch.zeros_like(self._idx)
        out: List[torch.Tensor] = []
        for pos in range(bs - 1):
            prev = torch.where(self._idx == pos, out[-1] if out else cur,
                               prev)
            final = self.draft.apply_logits_head(
                base4, prev_token_ids=prev[None, None], hidden_states=hidden4)
            out.append(final[0, 0, pos].argmax())
        return torch.stack(out)

    def _target_forward(self, ids, state: TargetState):
        logits, aux, ck, cv = target_cached_forward(
            self.target_params, self.target_config,
            torch.as_tensor(ids, device=self.device), state.cache_k,
            state.cache_v, state.length, self.capture_layers,
            rope=self._t_rope)
        new_state = TargetState(cache_k=ck, cache_v=cv,
                                length=state.length + ids.shape[1])
        return logits, aux.float(), new_state

    def _context_buffer(self) -> torch.Tensor:
        """The fp32 context features over the budget [1, max_len,
        n_capture·h]."""
        width = len(self.capture_layers) * self.target_config.hidden_size
        return torch.zeros((1, self.max_len, width), dtype=torch.float32,
                           device=self.device)

    @torch.no_grad()
    def generate(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int,
        stop_token_ids: Optional[Sequence[int]] = None,
    ) -> SpecDecodeResult:
        """The host loop: the oracle the fused path is held to. The draft
        reads the context captured so far, ``[:start]``, a new length every
        round."""
        stop = set(stop_token_ids or ())
        bs = self.block_size
        prompt = np.asarray(prompt_ids, np.int64)[None]
        p_len = prompt.shape[1]
        self._check_prompt(p_len)
        t_state = init_target_state(self.target_config, 1, self.max_len,
                                    device=self.device)
        # context features of the positions the target has seen so far
        ctx_features = self._context_buffer()
        logits, aux, t_state = self._target_forward(prompt, t_state)
        ctx_features[:, :p_len] = aux
        cur_token = int(logits[0, -1].argmax())
        output = list(prompt_ids) + [cur_token]

        accept_lengths: List[int] = []
        steps = 0
        start = p_len  # the position of the current block's first token
        while (len(output) - p_len < max_new_tokens
               and start + bs < self.max_len):
            steps += 1
            # --- draft: one block forward, bs - 1 proposals ---
            cur = torch.tensor(cur_token, device=self.device)
            hidden = self._draft_forward(cur, ctx_features[:, :start], start)
            proposals = self._propose(hidden, cur).tolist()

            # --- target verification over the whole block ---
            block = np.asarray([[cur_token, *proposals]], np.int64)
            logits, aux, t_state = self._target_forward(block, t_state)
            posterior = logits[0].argmax(dim=-1).tolist()
            accepted = 0
            for j in range(bs - 1):
                if proposals[j] == posterior[j]:
                    accepted += 1
                else:
                    break
            emitted = [*proposals[:accepted], posterior[accepted]]
            output.extend(emitted)
            accept_lengths.append(accepted + 1)

            # roll the target cache back; the accepted positions' features
            # extend the context
            t_state = TargetState(cache_k=t_state.cache_k,
                                  cache_v=t_state.cache_v,
                                  length=t_state.length - bs + accepted + 1)
            ctx_features[:, start:start + accepted + 1] = aux[:, :accepted + 1]
            start += accepted + 1
            cur_token = posterior[accepted]
            if stop & set(emitted):
                break
        return SpecDecodeResult(output_ids=np.asarray(output),
                                accept_lengths=accept_lengths, steps=steps)

    @torch.no_grad()
    def _prefill_device(self, prompt: np.ndarray, t_ck, t_cv,
                        ctx: torch.Tensor) -> torch.Tensor:
        """Prefill for the fused path into the given caches and context
        buffer (zeroed first), everything on the device → the first
        token."""
        for buffer in (t_ck, t_cv, ctx):
            buffer.zero_()
        logits, aux, _, _ = target_cached_forward(
            self.target_params, self.target_config,
            torch.as_tensor(prompt, device=self.device), t_ck, t_cv, 0,
            self.capture_layers, rope=self._t_rope)
        ctx[:, :prompt.shape[1]] = aux.float()
        return logits[0, -1].argmax()

    @torch.no_grad()
    def generate_fused(
        self,
        prompt_ids: Sequence[int],
        max_new_tokens: int,
        stop_token_ids: Optional[Sequence[int]] = None,
    ) -> SpecDecodeResult:
        """``generate`` with each round fused into one program: on the card
        a CUDA graph replayed once a round (the block forward over the
        whole budget-sized context buffer, the proposals, the verification,
        acceptance and the buffers' writes), with one small status read a
        round. The DFlash mask is index-based (context slot < anchor), so
        slots at or past the anchor are masked exactly, and the garbage a
        rejected block leaves there is overwritten before a later anchor
        can expose it. The same tokens and accept lengths as ``generate``
        (tested)."""
        stop_ids = _stop_ids(stop_token_ids)
        prompt = np.asarray(prompt_ids, np.int64)[None]
        p_len = prompt.shape[1]
        self._check_prompt(p_len)

        program, s = self._fused.block(self.max_len)
        _fill_stop(s.stop, stop_ids)
        cur = self._prefill_device(prompt, s.t_ck, s.t_cv, s.ctx)
        s.t_len.fill_(p_len)
        s.cur.copy_(cur)
        s.out_buf.zero_()
        s.out_buf[:1].copy_(cur.view(1))
        s.out_cnt.fill_(1)
        s.acc_buf.zero_()
        s.n_rounds.zero_()
        s.done.zero_()
        s.max_new.fill_(max_new_tokens)
        go = 1 < max_new_tokens and p_len + self.block_size < self.max_len
        while go:
            program()
            go = bool(s.status[0])
        out_cnt, n_rounds = int(s.out_cnt), int(s.n_rounds)
        output = np.concatenate([np.asarray(prompt_ids, np.int64),
                                 s.out_buf[:out_cnt].cpu().numpy()])
        return SpecDecodeResult(
            output_ids=output,
            accept_lengths=s.acc_buf[:n_rounds].cpu().tolist(),
            steps=n_rounds)

    def generate_batch_fused(self, *args, **kwargs):
        raise ValueError(f"generate_batch_fused: {BATCH_LATER}")


class _FusedDFlashLoops:
    """Fused block rounds for one ``DFlashSpecDecoder``: one program (a
    CUDA graph on the card) per cache budget, serving every stop set and
    prompt length (the stop set is data in the program's buffer; the
    prefill runs eagerly). ``replays`` counts graph replays."""

    def __init__(self, decoder: DFlashSpecDecoder):
        self.decoder = decoder
        self._cache: Dict[Any, Tuple[_Program, SimpleNamespace]] = {}
        self.replays = 0

    def block(self, budget: int) -> Tuple[_Program, SimpleNamespace]:
        key = ("block", budget)
        if key not in self._cache:
            s = self._block_state(budget)
            program = _Program(functools.partial(self._block_round, s),
                               self.decoder.device, self)
            self._cache[key] = (program, s)
        return self._cache[key]

    def _block_state(self, budget: int) -> SimpleNamespace:
        d = self.decoder
        dev, bs = d.device, d.block_size
        s = SimpleNamespace()  # the program's static buffers
        t_state = init_target_state(d.target_config, 1, budget, device=dev)
        s.t_ck, s.t_cv = t_state.cache_k, t_state.cache_v
        s.ctx = d._context_buffer()
        for name in ("t_len", "cur", "out_cnt", "n_rounds", "max_new"):
            setattr(s, name, _scalar(0, dev))
        s.done = torch.zeros((), dtype=torch.bool, device=dev)
        s.out_buf = torch.zeros(budget + bs, dtype=torch.long, device=dev)
        s.acc_buf = torch.zeros(budget, dtype=torch.long, device=dev)
        s.stop = torch.full((STOP_SLOTS,), -1, dtype=torch.long, device=dev)
        s.status = torch.zeros(3, dtype=torch.long, device=dev)
        return s

    def _block_round(self, s: SimpleNamespace) -> None:
        """One block round over the static buffers (JAX's loop body), then
        the loop condition into ``s.status``: (go on, output count,
        rounds)."""
        d = self.decoder
        bs, idx = d.block_size, d._idx
        budget = s.t_ck.shape[3]
        hidden = d._draft_forward(s.cur, s.ctx, s.t_len)
        proposals = d._propose(hidden, s.cur)                   # [bs - 1]
        block = torch.cat([s.cur.view(1), proposals])[None]
        logits, aux, _, _ = target_cached_forward(
            d.target_params, d.target_config, block, s.t_ck, s.t_cv, s.t_len,
            d.capture_layers, rope=d._t_rope)
        posterior = logits[0].argmax(dim=-1)
        matches = (proposals == posterior[:bs - 1]).long()
        acc = torch.cumprod(matches, dim=0).sum()
        bonus = posterior.index_select(0, acc.view(1))
        emitted = torch.where(idx < acc, torch.cat([proposals, bonus]),
                              bonus)                                 # [bs]
        start = s.out_cnt.clamp(max=s.out_buf.shape[0] - bs)
        s.out_buf.index_copy_(0, start + idx, emitted)
        s.acc_buf.index_copy_(
            0, s.n_rounds.clamp(max=s.acc_buf.shape[0] - 1).view(1),
            (acc + 1).view(1))
        # the whole block's features land in the buffer; the slots past
        # acc + 1 lie at or past the next anchor, masked until overwritten
        s.ctx.index_copy_(1, s.t_len.clamp(0, budget - bs) + idx,
                          aux.float())
        s.done.copy_(_fused_stop_hit(emitted, idx <= acc, s.stop))
        s.t_len.add_(acc + 1)
        s.cur.copy_(bonus[0])
        s.out_cnt.add_(acc + 1)
        s.n_rounds.add_(1)
        go = (~s.done) & (s.out_cnt < s.max_new) & (s.t_len + bs < budget)
        s.status.copy_(torch.stack([go.long(), s.out_cnt, s.n_rounds]))


# --------------------------------------------------------------------------
# plain greedy decoding
# --------------------------------------------------------------------------

def _plain_program(target_params, target_config: TargetConfig, max_len: int,
                   device) -> Tuple[_Program, SimpleNamespace]:
    s = SimpleNamespace()
    state = init_target_state(target_config, 1, max_len, device=device)
    s.ck, s.cv = state.cache_k, state.cache_v
    for name in ("t_len", "tok", "cnt", "max_new"):
        setattr(s, name, _scalar(0, device))
    s.done = torch.zeros((), dtype=torch.bool, device=device)
    s.out_buf = torch.zeros(max_len + 1, dtype=torch.long, device=device)
    s.status = torch.zeros(2, dtype=torch.long, device=device)
    s.stop = torch.full((STOP_SLOTS,), -1, dtype=torch.long, device=device)
    s.rope = rope_table(RopeSpec.from_config(target_config), max_len,
                        torch.bfloat16, device)
    one = torch.ones(1, dtype=torch.bool, device=device)

    def step():
        logits, _, _, _ = target_cached_forward(
            target_params, target_config, s.tok.view(1, 1), s.ck, s.cv,
            s.t_len, (), rope=s.rope)
        nxt = logits[0, -1].argmax()
        s.out_buf.index_copy_(0, s.cnt.clamp(max=max_len).view(1),
                              nxt.view(1))
        s.done.copy_(_fused_stop_hit(nxt.view(1), one, s.stop))
        s.t_len.add_(1)
        s.tok.copy_(nxt)
        s.cnt.add_(1)
        go = (~s.done) & (s.cnt < s.max_new) & (s.t_len + 1 < max_len)
        s.status.copy_(torch.stack([go.long(), s.cnt]))

    return _Program(step, device, fused_plain_decode), s


@torch.no_grad()
def fused_plain_decode(
    target_params, target_config: TargetConfig, prompt_ids,
    max_new_tokens: int, max_len: int = 512,
    stop_token_ids: Optional[Sequence[int]] = None,
    loop_cache: Optional[Dict[Any, Any]] = None,
) -> np.ndarray:
    """Plain greedy decoding, each token step one program (a CUDA graph on
    the card, replayed once a token): the wall-clock baseline speculative
    decoding must beat. Token for token ``greedy_target_decode``'s
    (tested). ``loop_cache``: a dict that keeps the programs for later
    calls on the same weights (a decoder's ``plain_loops``); without one
    each call builds its own."""
    check_dense_target(target_config)
    stop_ids = _stop_ids(stop_token_ids)
    device = target_params["model.embed_tokens.weight"].device
    ids = np.asarray(prompt_ids, np.int64)[None]
    if ids.shape[1] > max_len:
        raise ValueError(f"a prompt of {ids.shape[1]} tokens does not fit "
                         f"max_len={max_len}")
    key = (id(target_params), id(target_config), max_len)
    entry = None if loop_cache is None else loop_cache.get(key)
    if entry is None:
        program, s = _plain_program(target_params, target_config, max_len,
                                    device)
        # the entry holds the weights, so their ids name them while it lives
        entry = (program, s, target_params, target_config)
        if loop_cache is not None:
            loop_cache[key] = entry
    program, s = entry[0], entry[1]

    s.ck.zero_()
    s.cv.zero_()
    _fill_stop(s.stop, stop_ids)
    logits, _aux, _, _ = target_cached_forward(
        target_params, target_config, torch.as_tensor(ids, device=device),
        s.ck, s.cv, 0, (), rope=s.rope)
    first = logits[0, -1].argmax()
    s.t_len.fill_(ids.shape[1])
    s.tok.copy_(first)
    s.out_buf.zero_()
    s.out_buf[:1].copy_(first.view(1))
    s.cnt.fill_(1)
    s.max_new.fill_(max_new_tokens)
    # the first token may stop the run before any step (same budget guard as
    # the batched loop: without it prompt_len + max_new_tokens > max_len
    # would overwrite the cache tail instead of stopping)
    go = (int(first) not in stop_ids and 1 < max_new_tokens
          and ids.shape[1] + 1 < max_len)
    while go:
        program()
        go = bool(s.status[0])
    cnt = int(s.cnt)
    return np.concatenate([np.asarray(prompt_ids, np.int64),
                           s.out_buf[:cnt].cpu().numpy()])


#: graph replays of ``fused_plain_decode``'s token steps
fused_plain_decode.replays = 0


@torch.no_grad()
def greedy_target_decode(
    target_params, target_config: TargetConfig, prompt_ids, max_new_tokens,
    capture_layers=(0,), max_len: int = 512,
    stop_token_ids: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Plain greedy decoding, one host step a token: the correctness oracle
    for speculative decoding."""
    check_dense_target(target_config)
    stop = set(stop_token_ids or ())
    device = target_params["model.embed_tokens.weight"].device
    state = init_target_state(target_config, 1, max_len, device=device)
    ids = torch.as_tensor(np.asarray(prompt_ids, np.int64)[None],
                          device=device)
    logits, _aux, ck, cv = target_cached_forward(
        target_params, target_config, ids, state.cache_k, state.cache_v, 0,
        tuple(capture_layers))
    state = TargetState(cache_k=ck, cache_v=cv, length=ids.shape[1])
    out = list(prompt_ids)
    tok = int(logits[0, -1].argmax())
    out.append(tok)
    for _ in range(max_new_tokens - 1):
        if tok in stop:
            break
        logits, _aux, ck, cv = target_cached_forward(
            target_params, target_config,
            torch.tensor([[tok]], device=device), state.cache_k,
            state.cache_v, state.length, tuple(capture_layers))
        state = TargetState(cache_k=ck, cache_v=cv, length=state.length + 1)
        tok = int(logits[0, -1].argmax())
        out.append(tok)
    return np.asarray(out)
