"""A target's parameters sharded over a capture mesh, and the arithmetic of
expert parallelism.

Counterpart of the JAX package's multi-device capture: there
``shard_pytree_like_params`` (``specforge_tpu/parallel/mesh.py:91-99``)
places every leaf with ``param_partition_spec``'s rule on a 1-D ``fsdp``
mesh and XLA inserts the all-gathers, and ``stack_moe_expert_params``
(``specforge_tpu/models/target/transformer.py:1305-1351``) keeps the
expert tables sharded on their expert dimension for ``_moe_mlp_ep``. The
port runs one process per rank (``parallel/mesh.py``), so:

- :class:`ShardedParams` holds this rank's parameters: the slice of every
  leaf the rule shards (the largest dimension divisible by the mesh size,
  ``parallel/mesh.py:param_partition_spec``) and every other leaf whole.
  The loader reads only the slice's bytes (:func:`load_sharded`); a whole
  sharded tensor never reaches the card. The forward gathers one layer's
  sharded leaves just before the layer and drops them after it
  (:meth:`ShardedParams.layer`), and the embedding what the batch looks
  up (:meth:`ShardedParams.lookup`). Compute stays replicated, as in
  the JAX runner: every rank runs the whole batch on whole weights, so its
  features are bit-identical to one process's.
- Under expert parallelism an MoE layer's per-expert weights become
  ``{prefix}.mlp.experts.{gate,up,down}_stacked`` [E, in, out], of which a
  rank keeps its ``E / ep`` experts and gathers none
  (:func:`stack_moe_expert_params`); gpt-oss's fused expert tensors are
  only cut on their expert dimension.
- :func:`ep_window` is ``_moe_mlp_ep``'s capacity arithmetic
  (``transformer.py:1485-1517``) on the host: which of a rank's sorted
  assignments fit its capacity ``cap = max(1, min(m, ceil(cf·m/ep)))`` and
  how many do not (``overflow``). :func:`ep_mix` computes a rank's
  contribution from exactly those rows: torch needs no static window, so
  no slack row is computed.
"""

from __future__ import annotations

import math
import re
from collections import ChainMap
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from specforge_tpu_torch.parallel.fsdp import gather_shards
from specforge_tpu_torch.parallel.mesh import Mesh, param_partition_spec
from specforge_tpu_torch.runtime.data_plane.feature_file import (
    _DTYPES,
    read_safetensors_header,
    read_safetensors_slices,
)

#: one expert's weight of a per-expert checkpoint (qwen, deepseek families)
EXPERT_WEIGHT = re.compile(
    r"^(model\.layers\.\d+\.mlp\.experts)\.(\d+)\.(gate|up|down)_proj\.weight$")
#: gpt-oss's fused expert tensors, [E, ...]
FUSED_EXPERTS = ("gate_up_proj", "gate_up_proj_bias", "down_proj",
                 "down_proj_bias")
_FUSED = re.compile(r"^model\.layers\.\d+\.mlp\.experts\.(%s)$"
                    % "|".join(FUSED_EXPERTS))
_LAYER = re.compile(r"^model\.layers\.(\d+)\.")

#: a slice along one dimension: (dim, first index, length)
Cut = Optional[Tuple[int, int, int]]


def experts_per_rank(num_experts: int, ep: int) -> int:
    """E / ep, or JAX's error when the experts do not divide."""
    if num_experts % ep:
        raise ValueError(f"num_experts={num_experts} not divisible by "
                         f"fsdp={ep}")
    return num_experts // ep


class ShardedParams(dict):
    """This rank's target parameters on ``mesh``: a dict of local tensors.
    ``dims`` maps each key to its sharded dimension (None: whole on every
    rank). Under expert parallelism the stacked expert tables are the
    rank's own (``dims`` None) and never gathered. ``gathered`` counts the
    gathers' calls and whole bytes."""

    def __init__(self, local: Mapping[str, torch.Tensor], mesh: Mesh,
                 dims: Mapping[str, Optional[int]]):
        super().__init__(local)
        self.mesh = mesh
        self.dims = dict(dims)
        self.gathered = {"calls": 0, "bytes": 0}
        self._by_layer: Optional[Dict[int, List[str]]] = None

    def _sharded_keys(self, layer: int) -> List[str]:
        if self._by_layer is None:  # the dims are fixed once loaded
            self._by_layer = {}
            for key, dim in self.dims.items():
                match = _LAYER.match(key)
                if dim is not None and match and key in self:
                    self._by_layer.setdefault(int(match.group(1)),
                                              []).append(key)
        return self._by_layer.get(layer, [])

    def whole(self, key: str) -> torch.Tensor:
        """The tensor under ``key``, gathered when it is sharded."""
        if self.dims.get(key) is None:
            return self[key]
        whole = gather_shards(self[key], self.dims[key], self.mesh)
        self.gathered["calls"] += 1
        self.gathered["bytes"] += whole.numel() * whole.element_size()
        return whole

    def layer(self, index: int) -> Mapping[str, torch.Tensor]:
        """The parameters with decoder layer ``index``'s sharded leaves
        gathered whole; the gathered tensors live as long as the
        mapping."""
        whole = {key: self.whole(key) for key in self._sharded_keys(index)}
        return ChainMap(whole, self)

    def lookup(self, key: str, ids: torch.Tensor) -> torch.Tensor:
        """``table[ids]`` for the table under ``key``: over NCCL from the
        whole table gathered, over gloo from only the rows ``ids`` uses
        (:meth:`rows`). Both are exact. On NVIDIA H100 80GB HBM3 cards at
        700.00 W (``chip_smoke.py``'s ``capture_mesh`` lines) the whole
        Llama-3-70B table took 5.4-5.6 ms over NCCL and its rows 2-130 ms
        (the host's work in the way); over host-staged gloo the Qwen3-8B
        table took 1,803 ms and its rows 65-70 ms."""
        if self.dims.get(key) is not None and self.mesh.transport == "nccl":
            return self.whole(key)[ids]
        return self.rows(key, ids)

    def rows(self, key: str, ids: torch.Tensor) -> torch.Tensor:
        """``table[ids]``, moving only the rows ``ids`` uses: each rank
        contributes its slice of those rows and the owner's copy of each is
        kept, so the result is exact."""
        table, dim = self[key], self.dims.get(key)
        if dim is None:
            return table[ids]
        uniq, inverse = torch.unique(ids, return_inverse=True)
        if dim == 0:
            n = table.shape[0]
            local = table[(uniq - self.mesh.fsdp_rank * n).clamp(0, n - 1)]
            every = gather_shards(local, 0, self.mesh).view(
                (self.mesh.fsdp_size,) + tuple(local.shape))
            rows = every[uniq // n, torch.arange(uniq.numel(),
                                                 device=uniq.device)]
        else:
            rows = gather_shards(table[uniq], dim, self.mesh)
        # dim 0: every rank sent a copy of each row, the owner's kept
        copies = self.mesh.fsdp_size if dim == 0 else 1
        self.gathered["calls"] += 1
        self.gathered["bytes"] += copies * rows.numel() * rows.element_size()
        return rows[inverse]

    def resident_bytes(self) -> int:
        """The bytes of this rank's tensors (a tied head counted once)."""
        seen, total = set(), 0
        for t in self.values():
            if t.data_ptr() in seen:
                continue
            seen.add(t.data_ptr())
            total += t.numel() * t.element_size()
        return total


def _cut(shape: Sequence[int], itemsize: int, mesh: Mesh) -> Cut:
    """This rank's slice of a tensor by ``param_partition_spec``'s rule."""
    dim = param_partition_spec(shape, itemsize, mesh.fsdp_size)
    if dim is None:
        return None
    n = shape[dim] // mesh.fsdp_size
    return dim, mesh.fsdp_rank * n, n


def _expert_cut(key: str, cfg, mesh: Mesh, expert_parallel: bool):
    """(kind, cut) of an expert tensor under expert parallelism: ``skip``
    (another rank's expert), ``stack`` (one of this rank's) or ``fused``
    (gpt-oss's [E, ...], cut to this rank's experts); None otherwise."""
    if not expert_parallel:
        return None
    e_local = experts_per_rank(cfg.num_experts, mesh.fsdp_size)
    lo = mesh.fsdp_rank * e_local
    match = EXPERT_WEIGHT.match(key)
    if match:
        j = int(match.group(2))
        return ("stack", None) if lo <= j < lo + e_local else ("skip", None)
    if _FUSED.match(key):
        return "fused", (0, lo, e_local)
    return None


def _stack_layers(per_expert: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Per-expert weights (HF layout [out, in]) → one
    ``{prefix}.{gate,up,down}_stacked`` per layer and projection, [n, in,
    out] in expert order: a transposed view of the [n, out, in] stack, so
    ``rows @ stacked[j]`` is the product ``_linear`` takes."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for key in per_expert:
        prefix, j, name = EXPERT_WEIGHT.match(key).groups()
        groups.setdefault(f"{prefix}.{name}_stacked", []).append((int(j), key))
    out = {}
    for stacked, members in groups.items():
        members.sort()
        out[stacked] = torch.stack(
            [per_expert.pop(key) for _, key in members]).transpose(1, 2)
    return out


def stack_moe_expert_params(params: Mapping[str, torch.Tensor], cfg,
                            mesh: Optional[Mesh] = None
                            ) -> Dict[str, torch.Tensor]:
    """The per-expert weights of every MoE layer replaced by
    ``{prefix}.mlp.experts.{gate,up,down}_stacked`` [E, in, out]; on a
    ``mesh`` only this rank's ``E / ep`` experts are kept (gpt-oss's fused
    [E, ...] tensors are only cut on the expert dimension). Idempotent:
    stacked tables and cut fused tensors are left as they are. Raises when
    ``num_experts`` does not divide by the mesh size (JAX's message)."""
    out = dict(params)
    ep = 1 if mesh is None else mesh.fsdp_size
    e_local = experts_per_rank(cfg.num_experts, ep)
    lo = 0 if mesh is None else mesh.fsdp_rank * e_local
    per_expert = {}
    for key in list(out):
        match = EXPERT_WEIGHT.match(key)
        if match:
            j = int(match.group(2))
            w = out.pop(key)
            if lo <= j < lo + e_local:
                per_expert[key] = w
        elif (_FUSED.match(key) and e_local < cfg.num_experts
              and out[key].shape[0] == cfg.num_experts):
            out[key] = out[key][lo:lo + e_local]
    out.update(_stack_layers(per_expert))
    return out


def load_sharded(files: Mapping[str, Sequence[Tuple[str, str]]], cfg,
                 dtype: torch.dtype, device: torch.device, mesh: Mesh,
                 expert_parallel: bool = False) -> ShardedParams:
    """This rank's parameters from safetensors files: ``files`` maps each
    file to its (stored key, canonical key) pairs. Each tensor is read
    whole, cut to this rank's slice (only the slice's bytes are touched),
    or skipped (another rank's expert), then moved to ``device``; floating
    tensors are cast to ``dtype`` there. The rule is applied to the loaded
    dtype's sizes, as the JAX package shards the loaded arrays."""
    local, dims = {}, {}
    per_expert: Dict[str, torch.Tensor] = {}
    for path, keys in sorted(files.items()):
        header = read_safetensors_header(path)
        plan: Dict[str, Cut] = {}
        names = {}
        for stored, key in keys:
            info = header[stored]
            shape = tuple(info["shape"])
            stored_dtype = _DTYPES[info["dtype"]]
            itemsize = (dtype.itemsize if stored_dtype.is_floating_point
                        else stored_dtype.itemsize)
            expert = _expert_cut(key, cfg, mesh, expert_parallel)
            if expert is not None:
                kind, cut = expert
                if kind == "skip":
                    continue
            else:
                cut = _cut(shape, itemsize, mesh)
                dims[key] = None if cut is None else cut[0]
            plan[stored] = cut
            names[stored] = key
        for stored, value in read_safetensors_slices(path, plan).items():
            value = value.to(device)
            if value.is_floating_point():
                value = value.to(dtype)
            key = names[stored]
            if EXPERT_WEIGHT.match(key) and expert_parallel:
                per_expert[key] = value
            else:
                local[key] = value
                dims.setdefault(key, None)
    for key, value in _stack_layers(per_expert).items():
        local[key], dims[key] = value, None
    return ShardedParams(local, mesh, dims)


# -- expert parallelism ----------------------------------------------------

def ep_capacity(m: int, ep: int, capacity_factor: Optional[float]) -> int:
    """A rank's row budget: all ``m`` assignments without a factor, else
    ``max(1, min(m, ceil(cf·m/ep)))``."""
    if capacity_factor is None:
        return m
    return max(1, min(m, int(math.ceil(capacity_factor * m / ep))))


def ep_window(sizes: Sequence[int], rank: int, e_local: int, m: int,
              cap: int) -> Tuple[List[int], int]:
    """``_moe_mlp_ep``'s window on rank ``rank`` (``transformer.py:
    1485-1517``), from the expert groups' sizes of the sorted assignments
    → (the rows computed of each local expert's group, its first rows;
    the rank's rows not computed, its overflow). The rank's window is
    ``cap`` sorted rows from ``start_cl = clip(start, 0, m - cap)``; its
    own rows begin ``pre = start - start_cl`` into it and ``cap - pre``
    of them fit."""
    lo = rank * e_local
    start = sum(sizes[:lo])
    local_rows = sum(sizes[lo:lo + e_local])
    start_cl = min(max(start, 0), m - cap)
    avail = max(cap - (start - start_cl), 0)
    used, cum, before = [], 0, 0
    for n in sizes[lo:lo + e_local]:
        cum += n
        fit = min(cum, avail)
        used.append(fit - before)
        before = fit
    return used, local_rows - before


#: one local expert's computation: (local expert index, rows [n, h]) → [n, h]
LocalExpert = Callable[[int, torch.Tensor], torch.Tensor]


def ep_mix(x: torch.Tensor, top_w: torch.Tensor, top_i: torch.Tensor,
           valid: Optional[torch.Tensor], num_experts: int, ep: int,
           rank: int, cap: int, expert: LocalExpert
           ) -> Tuple[torch.Tensor, int]:
    """Rank ``rank``'s share of the expert mix of ``x`` [t, h] → (Σ over
    the token's assignments computed here of w·expert(x) [t, h], the
    overflow of every rank). The assignments are sorted by expert id
    (stably); a padding token (``valid`` 0) joins no group and uses no
    capacity. Each local expert runs once over the rows of its group that
    fit the window; every row goes back to its (token, k) slot by an
    assignment of distinct slots and the k slots are summed in order, so a
    run repeats bit for bit (no atomics). The routing is the same on
    every rank, so every rank counts every rank's overflow itself."""
    t, h = x.shape
    k = top_i.shape[1]
    m = t * k
    flat = top_i.reshape(-1)
    if valid is not None:
        keep = valid.reshape(t).to(device=flat.device,
                                   dtype=torch.bool).repeat_interleave(k)
        flat = torch.where(keep, flat, num_experts)
    order = torch.argsort(flat, stable=True)
    sizes = torch.bincount(flat, minlength=num_experts + 1)[
        :num_experts].tolist()
    e_local = experts_per_rank(num_experts, ep)
    overflow = sum(ep_window(sizes, p, e_local, m, cap)[1]
                   for p in range(ep))
    used, _ = ep_window(sizes, rank, e_local, m, cap)
    out = x.new_zeros((m, h))
    weights = top_w.reshape(-1)
    start = sum(sizes[:rank * e_local])
    for j, n in enumerate(used):
        if n:
            slots = order[start:start + n]
            y = expert(j, x[slots // k])
            out[slots] = y.to(out.dtype) * weights[slots][:, None].to(
                out.dtype)
        start += sizes[rank * e_local + j]
    return out.view(t, k, h).sum(dim=1), overflow

