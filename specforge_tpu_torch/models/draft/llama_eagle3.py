"""EAGLE3 draft model — a 1-layer Llama-style decoder over concat(embed, hidden).

Counterpart of ``specforge_tpu/models/draft/llama_eagle3.py``, with the same
module names, so weights carry over (``specforge_tpu_torch.convert``):

- ``embed_tokens``       — target-copied embedding.
- ``fc``                 — [3*target_hidden → hidden] aux-layer projection,
                           optionally preceded by per-chunk RMSNorms
                           ``fc_norm_{0,1,2}`` (the EAGLE3.1 variant).
- ``midlayer``           — one decoder layer whose merged ``qkv_proj`` reads
                           the 2*hidden concat of the normed input embedding
                           and the normed hidden state; ``gate_up_proj`` is
                           merged too.
- ``norm`` + ``lm_head`` — draft-vocab head (``norm_output`` gates the norm).
- ``t2d``/``d2t``        — vocab-mapping buffers.

Parameters are fp32; every matrix product runs in ``dtype`` (bf16 by
default); RMSNorm computes its statistics in fp32. ``attention_backend`` is
``"dense"`` (the plain reference), ``"pallas"`` — the name the configs use;
here it selects the hand-written TTT flash-attention kernel — or ``"usp"``:
sequence-parallel attention over the ranks of a
:class:`~specforge_tpu_torch.parallel.mesh.Mesh` (Ulysses × ring, with the
LSE ring-hop kernel), where each rank holds one sequence chunk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from specforge_tpu_torch.models.draft.base import DraftModelConfig
from specforge_tpu_torch.ops.attention import (
    make_causal_bias,
    ttt_branch_attention,
)
from specforge_tpu_torch.ops.attention_cuda import ttt_flash_attention
from specforge_tpu_torch.ops.rope import (
    RopeSpec,
    apply_multimodal_rope,
    apply_rope,
    rope_cos_sin,
)
from specforge_tpu_torch.parallel.usp import (
    ulysses_scatter_heads,
    usp_ttt_attention_scattered,
)
from specforge_tpu_torch.utils import DeviceLike, resolve_device

ACT_FNS = {
    "silu": F.silu,
    "gelu": F.gelu,
    "relu": F.relu,
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
}

ATTENTION_BACKENDS = ("dense", "pallas", "usp")

Cache = Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]


@dataclass(frozen=True)
class Eagle3Config(DraftModelConfig):
    draft_vocab_size: int = 32000
    target_hidden_size: Optional[int] = None
    fc_norm: bool = False          # EAGLE3.1: per-chunk RMSNorm before fc
    norm_output: bool = True       # apply final norm before lm_head

    @property
    def resolved_target_hidden_size(self) -> int:
        return self.target_hidden_size or self.hidden_size


class RMSNorm(nn.Module):
    """RMSNorm with fp32 statistics, output in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        x32 = x32 * torch.rsqrt(var + self.eps)
        return self.weight.to(dtype) * x32.to(dtype)


class Linear(nn.Module):
    """Projection with an fp32 [out, in] weight (and, when ``bias``, an fp32
    bias initialised to 0), computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype, device=None,
                 bias: bool = False):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device)
        )
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Eagle3Attention(nn.Module):
    def __init__(self, config: Eagle3Config, dtype, attention_backend: str,
                 device=None, mesh=None):
        super().__init__()
        if attention_backend not in ATTENTION_BACKENDS:
            raise ValueError(
                f"attention_backend {attention_backend!r} not in "
                f"{ATTENTION_BACKENDS}"
            )
        if (attention_backend == "usp") != (mesh is not None):
            raise ValueError("attention_backend='usp' takes a mesh, and only "
                             "it does")
        self.config = config
        self.attention_backend = attention_backend
        self.mesh = mesh
        d = config.resolved_head_dim
        h, kvh = config.num_attention_heads, config.num_key_value_heads
        self.qkv_proj = Linear(2 * config.hidden_size, (h + 2 * kvh) * d,
                               dtype, device)
        self.o_proj = Linear(h * d, config.hidden_size, dtype, device)
        self.rope_spec = RopeSpec.from_config(config)

    def forward(
        self,
        hidden_2h: torch.Tensor,
        cache: Cache,
        bias: Optional[torch.Tensor],
        position_ids: torch.Tensor,
        key_valid: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Cache]:
        """One TTT attention step.

        hidden_2h [B, S, 2*hidden]; cache: (keys, values) tuples of earlier
        branches [B, KVH, S, D]; bias [B, 1, S, S] (dense backend) or None;
        position_ids [B, S] (or mrope's [3, B, S]); key_valid [B, S] (kernel
        backends).
        Returns (attn_out [B, S, hidden], new_cache).

        Under ``"usp"`` S is this rank's chunk, position_ids are global,
        and the cache holds each branch's K/V after the Ulysses exchange,
        expanded to the full head count first (the exchange divides heads
        across ranks), so each step's K/V cross once."""
        cfg = self.config
        b, s, _ = hidden_2h.shape
        d = cfg.resolved_head_dim
        h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
        qc, kc = h * d, kvh * d
        qkv = self.qkv_proj(hidden_2h)
        q = qkv[..., :qc].view(b, s, h, d).transpose(1, 2)
        k = qkv[..., qc:qc + kc].view(b, s, kvh, d).transpose(1, 2)
        v = qkv[..., qc + kc:].view(b, s, kvh, d).transpose(1, 2)

        lck = len(cache[0])
        seq = s * self.mesh.sp_size if self.mesh is not None else s
        spec = self.rope_spec
        if spec.scaling_type == "mrope" and position_ids.dim() == 2:
            # text only: all three mrope axes share the positions
            position_ids = position_ids.expand(3, *position_ids.shape)
        cos, sin = rope_cos_sin(spec, position_ids + lck, seq + lck,
                                dtype=q.dtype)
        if spec.scaling_type == "mrope":
            q, k = apply_multimodal_rope(q, k, cos, sin, spec.mrope_section)
        else:
            q, k = apply_rope(q, k, cos, sin)
        if self.attention_backend == "usp":
            mesh, g = self.mesh, h // kvh
            keys = tuple(cache[0]) + (ulysses_scatter_heads(
                k.repeat_interleave(g, dim=1), mesh),)
            values = tuple(cache[1]) + (ulysses_scatter_heads(
                v.repeat_interleave(g, dim=1), mesh),)
            attn_out = usp_ttt_attention_scattered(
                mesh, ulysses_scatter_heads(q, mesh), keys, values, key_valid)
            return self.o_proj(attn_out), (keys, values)
        keys = tuple(cache[0]) + (k,)
        values = tuple(cache[1]) + (v,)
        if self.attention_backend == "pallas":
            attn_out = ttt_flash_attention(q, keys, values, key_valid=key_valid)
        else:
            attn_out = ttt_branch_attention(q, keys, values, bias)
        return self.o_proj(attn_out), (keys, values)


class Eagle3MLP(nn.Module):
    def __init__(self, config: Eagle3Config, dtype, device=None):
        super().__init__()
        f = config.intermediate_size
        self.act = ACT_FNS[config.hidden_act]
        self.gate_up_proj = Linear(config.hidden_size, 2 * f, dtype, device)
        self.down_proj = Linear(f, config.hidden_size, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        return self.down_proj(self.act(gate) * up)


class Eagle3DecoderLayer(nn.Module):
    def __init__(self, config: Eagle3Config, dtype, attention_backend: str,
                 device=None, mesh=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.self_attn = Eagle3Attention(config, dtype, attention_backend,
                                         device, mesh)
        self.mlp = Eagle3MLP(config, dtype, device)
        self.hidden_norm = RMSNorm(config.hidden_size, eps, device)
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps, device)

    def forward(self, input_emb, hidden_states, cache, bias, position_ids,
                key_valid=None):
        residual = hidden_states
        hidden_2h = torch.cat(
            [self.input_layernorm(input_emb), self.hidden_norm(hidden_states)],
            dim=-1,
        )
        attn_out, cache = self.self_attn(
            hidden_2h, cache, bias, position_ids, key_valid
        )
        hidden_states = residual + attn_out
        residual = hidden_states
        hidden_states = self.mlp(self.post_attention_layernorm(hidden_states))
        return residual + hidden_states, cache


class LlamaEagle3Draft(nn.Module):
    """EAGLE3 draft model (architecture name kept for config interop).

    ``device`` defaults to CUDA (and raises without it); weights are drawn
    from ``generator`` (a :class:`torch.Generator` on that device) when given,
    else from a fresh one seeded with ``seed``, so every rank of a ``"usp"``
    run draws the same weights. ``mesh`` is the rank grid of the ``"usp"``
    backend."""

    def __init__(
        self,
        config: Eagle3Config,
        dtype: torch.dtype = torch.bfloat16,
        attention_backend: str = "dense",
        device: DeviceLike = None,
        seed: int = 0,
        generator: Optional[torch.Generator] = None,
        mesh=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.dtype = dtype
        self.attention_backend = attention_backend
        self.mesh = mesh
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                         device=device)
        self.midlayer = Eagle3DecoderLayer(config, dtype, attention_backend,
                                           device, mesh)
        th = config.resolved_target_hidden_size
        self.fc = Linear(3 * th, config.hidden_size, dtype, device)
        self.fc_norm = config.fc_norm
        if config.fc_norm:
            for i in range(3):
                setattr(self, f"fc_norm_{i}",
                        RMSNorm(th, config.rms_norm_eps, device))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device)
        self.lm_head = Linear(config.hidden_size, config.draft_vocab_size,
                              dtype, device)
        # identity vocab maps until a real mapping is loaded
        self.register_buffer(
            "t2d", torch.ones(config.vocab_size, dtype=torch.bool, device=device)
        )
        self.register_buffer(
            "d2t",
            torch.zeros(config.draft_vocab_size, dtype=torch.int64, device=device),
        )
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(seed)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init: unit-normal embedding, fan-in-scaled normal
        projections, unit norm weights."""
        self.embed_tokens.weight.normal_(0.0, 1.0, generator=generator)
        for module in self.modules():
            if isinstance(module, Linear):
                fan_in = module.weight.shape[1]
                module.weight.normal_(0.0, fan_in ** -0.5, generator=generator)

    def set_vocab_maps(self, t2d, d2t) -> None:
        self.t2d.copy_(torch.as_tensor(t2d, dtype=torch.bool))
        self.d2t.copy_(torch.as_tensor(d2t, dtype=torch.int64))

    # --- functional pieces used by the TTT loop ----------------------------

    def embed_input_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids).to(self.dtype)

    def project_hidden_states(self, hidden_3h: torch.Tensor) -> torch.Tensor:
        """[B, S, 3*target_hidden] aux concat → [B, S, hidden]."""
        th = self.config.resolved_target_hidden_size
        if hidden_3h.shape[-1] != 3 * th:
            raise ValueError(
                f"expected aux concat of 3*{th}, got {hidden_3h.shape[-1]}"
            )
        if self.fc_norm:
            chunks = hidden_3h.chunk(3, dim=-1)
            hidden_3h = torch.cat(
                [getattr(self, f"fc_norm_{i}")(c) for i, c in enumerate(chunks)],
                dim=-1,
            )
        return self.fc(hidden_3h)

    def ttt_step(self, input_embeds, hidden_states, cache, bias, position_ids,
                 key_valid=None):
        """One decoder-layer step of the TTT unroll → (hidden_out, new_cache)."""
        return self.midlayer(input_embeds, hidden_states, cache, bias,
                             position_ids, key_valid)

    def compute_logits(self, hidden_states: torch.Tensor) -> torch.Tensor:
        h = self.norm(hidden_states) if self.config.norm_output else hidden_states
        return self.lm_head(h)

    def forward(self, input_ids, hidden_3h, position_ids=None):
        """Single forward: embed + project + 1 step + logits."""
        b, s = input_ids.shape
        embeds = self.embed_input_ids(input_ids)
        hidden = self.project_hidden_states(hidden_3h)
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device).expand(b, s)
        bias = None
        if self.attention_backend == "dense":
            bias = make_causal_bias(None, b, s, device=input_ids.device)
        hidden, _ = self.ttt_step(embeds, hidden, ((), ()), bias, position_ids)
        return self.compute_logits(hidden)
