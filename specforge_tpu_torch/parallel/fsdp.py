"""Data parallelism and ZeRO-3-style sharding of the training state.

Counterpart of the JAX package's ``dp``/``fsdp`` mesh axes
(``shard_pytree_like_params``, ``specforge_tpu/parallel/mesh.py:91-100``):
there ``jit`` sees the global arrays and inserts the all-gathers and
reduce-scatters itself. The port runs one process per rank, so a
:class:`ShardPlan` moves the shards by hand, over the mesh's groups
(``parallel/mesh.py``), on the mesh's transport (NCCL, or gloo over host
copies: ``usp.Staged``):

- **What is sharded.** Every parameter of the training model follows
  :func:`~specforge_tpu_torch.parallel.mesh.param_partition_spec` on its
  whole shape: a rank keeps slice ``f`` of the sharded dimension of the
  fp32 masters and of the draft's frozen tables (EAGLE3's bf16 embedding),
  and of the Adam moments ``mu``/``nu``; the factored ``nu_row``/``nu_col``
  keep the parameter's shard on the dimensions they keep, and are whole
  along a sharded dimension they sum over (their sums are fsdp sums). The
  row-sparse embedding's ``nu_row``/``nu_col`` stay whole: every rank sums
  the same gathered rows. Buffers and the frozen target tables stay whole
  on every rank.
- **Each micro-step** the shards, cast to the compute dtype first, are
  all-gathered over the fsdp group into whole tensors (:meth:`gather_params`),
  which the strategy gets in place of the model's parameters; the step
  differentiates with respect to them. An embedding table the model only
  looks rows up in, and takes no gradient of (EAGLE3's frozen embedding,
  P-EAGLE's row-sparse one), moves only the rows the micro-batch can look
  up (:meth:`lookup_rows`: the strategy's ``lookup_ids``), into a
  whole-shaped table that is zero elsewhere.
- **At the end of each window** each gradient is reduce-scattered in fp32
  over the fsdp group and summed over the replica group, a tensor kept
  whole is summed over all ranks (:meth:`reduce_grads`); the global norm
  sums the shards' squares over the fsdp group and counts a whole tensor
  once (``optimizer.global_norm``). Every rank of a replica group then ends
  the step with bit-identical shards: no rank sums in another order.
- **Checkpoints** are written whole, as one process writes them: the ranks
  of rank 0's fsdp group gather one tensor at a time (:meth:`whole_state`),
  and every rank restores its own slices of the whole files
  (:meth:`local_tree`), so a checkpoint moves between topologies.

Why by hand and not FSDP2's ``fully_shard``: the train step is functional
(``functional_call`` over cast copies, ``autograd.grad``, an AdamW of its
own with factored and row-sparse updates); ``fully_shard`` works through
DTensor parameters, module hooks and ``.grad``, none of which the step uses.

With ``fsdp = 1`` (dp or USP alone) nothing is sharded and every gradient
is summed over all ranks.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Set, Tuple

import torch
import torch.distributed as dist
from torch import nn

from specforge_tpu_torch.parallel.mesh import Mesh, param_partition_spec
from specforge_tpu_torch.parallel.usp import Staged, all_reduce_sum

# the names of newer torch releases, which deprecate the older ones
_all_gather = getattr(dist, "all_gather_single", None) or (
    dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or (
    dist.reduce_scatter_tensor)


class ShardPlan:
    """Where each parameter of ``model`` is sharded on ``mesh``: ``dims``
    maps every parameter name to its sharded dimension (None: whole),
    ``shapes`` to its whole shape. Built from the whole model, before
    :meth:`shard_model_`."""

    def __init__(self, model: nn.Module, mesh: Mesh):
        self.mesh = mesh
        self.fsdp = mesh.fsdp_size
        self.shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        self.dims = {
            n: param_partition_spec(p.shape, p.element_size(), self.fsdp)
            for n, p in model.named_parameters()}

    @property
    def sharded(self) -> bool:
        return any(d is not None for d in self.dims.values())

    def dim(self, name: str) -> Optional[int]:
        return self.dims.get(name)

    # --- slices -----------------------------------------------------------
    def local(self, whole: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's slice ``f`` of ``whole`` along ``dim`` (a copy), or
        ``whole`` itself when ``dim`` is None."""
        if dim is None:
            return whole
        n = whole.shape[dim] // self.fsdp
        return whole.narrow(dim, self.mesh.fsdp_rank * n, n).clone(
            memory_format=torch.contiguous_format)

    def local_shape(self, shape: Tuple[int, ...], dim: Optional[int]
                    ) -> Tuple[int, ...]:
        if dim is None:
            return tuple(shape)
        return tuple(n // self.fsdp if i == dim else n
                     for i, n in enumerate(shape))

    @torch.no_grad()
    def shard_model_(self, model: nn.Module) -> None:
        """Keep only this rank's slice of every sharded parameter."""
        for name, p in model.named_parameters():
            p.data = self.local(p.data, self.dims[name])

    # --- collectives ------------------------------------------------------
    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from the fsdp group's slices of it along
        ``dim`` (no gradient)."""
        call = Staged(self.mesh, [x])
        src = call.stage(x.detach().movedim(dim, 0))
        out = src.new_empty((src.shape[0] * self.fsdp,) + src.shape[1:])
        _all_gather(out, src, group=self.mesh.fsdp_group)
        return call.done(out).movedim(0, dim).contiguous()

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` of the sum of ``x`` over the
        fsdp group."""
        call = Staged(self.mesh, [x])
        src = call.stage(x.movedim(dim, 0))
        out = src.new_empty((src.shape[0] // self.fsdp,) + src.shape[1:])
        _reduce_scatter(out, src, group=self.mesh.fsdp_group)
        return call.done(out).movedim(0, dim).contiguous()

    def fsdp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the fsdp group (``x`` itself at fsdp 1)."""
        if self.fsdp == 1:
            return x
        return all_reduce_sum(x, self.mesh, self.mesh.fsdp_group)

    # --- the train step ---------------------------------------------------
    def gather_params(self, model: nn.Module,
                      cast: Callable[[str, torch.Tensor], torch.Tensor],
                      grad_names: Set[str],
                      lookups: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
        """The model's parameters for one micro-step → (``params``: each
        sharded parameter whole, gathered after ``cast``, and each other
        one ``cast`` changed; ``leaves``: the gathered tensors of
        ``grad_names``, which require grad). ``lookups`` maps a table the
        model only looks rows up in to the ids it may look up: such a
        table outside ``grad_names``, sharded by rows, comes whole with
        just those rows (:meth:`lookup_rows`)."""
        params, leaves = {}, {}
        lookups = lookups or {}
        for name, p in model.named_parameters():
            x = cast(name, p)
            dim = self.dims[name]
            if dim is None:
                if x is not p:
                    params[name] = x
                continue
            if dim == 0 and name in lookups and name not in grad_names:
                params[name] = self.lookup_rows(x, lookups[name])
                continue
            whole = self.gather(x, dim)
            if name in grad_names:
                leaves[name] = whole.requires_grad_(True)
            params[name] = whole
        return params, leaves

    @torch.no_grad()
    def lookup_rows(self, shard: torch.Tensor, ids: torch.Tensor
                    ) -> torch.Tensor:
        """A table sharded by rows (this rank's slice ``shard``) → a
        whole-shaped table holding the rows ``ids`` (any shape, any order,
        repeats) and zeros elsewhere: every rank of the fsdp group sends
        each other rank the rows it asks for and owns, one all-to-all, so
        a micro-batch moves its few thousand rows, not the table."""
        mesh, f, dev = self.mesh, self.fsdp, shard.device
        n_rows = shard.shape[0]
        need = torch.unique(ids.reshape(-1).to(device=dev, dtype=torch.int64))
        # every rank's request, padded to the longest with -1
        call = Staged(mesh, [need])
        longest = call.stage(torch.tensor([need.numel()], device=dev))
        dist.all_reduce(longest, dist.ReduceOp.MAX, group=mesh.fsdp_group)
        n = int(longest)
        mine = torch.full((n,), -1, dtype=torch.int64, device=dev)
        mine[:need.numel()] = need
        src = call.stage(mine)
        asks = src.new_empty((f * n,))
        _all_gather(asks, src, group=mesh.fsdp_group)
        asks = call.done(asks)
        # the rows this rank owns of each rank's request
        local = asks.view(f, n) - mesh.fsdp_rank * n_rows
        owned = (local >= 0) & (local < n_rows)
        send = shard.new_zeros((f, n) + tuple(shard.shape[1:]))
        send[owned] = shard[local[owned]]
        call = Staged(mesh, [send])
        src = call.stage(send)
        recv = torch.empty_like(src)
        dist.all_to_all_single(recv, src, group=mesh.fsdp_group)
        recv = call.done(recv)
        # each row from its owner
        rows = recv[need // n_rows, torch.arange(need.numel(), device=dev)]
        whole = shard.new_zeros((n_rows * f,) + tuple(shard.shape[1:]))
        whole[need] = rows
        return whole

    @torch.no_grad()
    def whole_params(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """Every sharded parameter gathered whole, in its stored dtype (the
        eval pass)."""
        return {name: self.gather(p, self.dims[name])
                for name, p in model.named_parameters()
                if self.dims[name] is not None}

    def reduce_grads(self, grads: Dict[str, torch.Tensor]) -> None:
        """Whole gradients (each rank's share) → in place, this rank's fp32
        slice of their sum over all ranks: reduce-scatter over the fsdp
        group, then a sum over the replica group; a whole tensor's sum over
        every rank. One parameter at a time."""
        replicas = self.mesh.world_size // self.fsdp
        for name in list(grads):
            g = grads[name].float()
            dim = self.dims[name]
            if dim is None:
                grads[name] = all_reduce_sum(g, self.mesh)
                continue
            part = self.reduce_scatter(g, dim)
            del g
            grads[name] = (all_reduce_sum(part, self.mesh,
                                          self.mesh.replica_group)
                           if replicas > 1 else part)

    def gather_rows(self, ids: Sequence[torch.Tensor],
                    rows: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The row-sparse update's touched ids [n] and gradient rows [n, H]
        of each micro-step of a window, from every rank → all of them, in
        (micro-step, rank) order: the order of one process's batch, whose
        micro-batch is the ranks' blocks in rank order."""
        ids, rows = torch.stack(list(ids)), torch.stack(list(rows))
        call = Staged(self.mesh, [ids, rows])
        out = []
        for x in (ids, rows):
            src = call.stage(x)
            whole = src.new_empty((self.mesh.world_size * src.shape[0],)
                                  + src.shape[1:])
            _all_gather(whole, src)
            whole = whole.view((self.mesh.world_size,) + src.shape)
            out.append(call.done(whole.transpose(0, 1).flatten(0, 2)))
        return out[0], out[1]

    def slice_of(self, name: str) -> Optional[Tuple[int, int, int]]:
        """(dim, first index, length) of this rank's slice of parameter
        ``name``, or None when it is whole."""
        dim = self.dim(name)
        if dim is None:
            return None
        n = self.shapes[name][dim] // self.fsdp
        return dim, self.mesh.fsdp_rank * n, n

    # --- the optimizer state ----------------------------------------------
    def opt_leaf_dim(self, path: Tuple[str, ...]) -> Optional[int]:
        """The sharded dimension of the optimizer-state tensor at ``path``
        (``("mu", name)``, ``("dense", "nu_row", name)``, ...)."""
        if path and path[0] == "dense":
            path = path[1:]
        if len(path) != 2 or path[0] not in ("mu", "nu", "nu_row", "nu_col"):
            return None  # the count, the row-sparse state: whole
        kind, name = path
        d = self.dim(name)
        if d is None or kind in ("mu", "nu"):
            return d
        n = len(self.shapes[name])
        if kind == "nu_row":  # p.shape[:-1]: whole along a sharded last dim
            return None if d == n - 1 else d
        # nu_col, p.shape[:-2] + p.shape[-1:]: whole along a sharded dim -2
        return None if d == n - 2 else (n - 2 if d == n - 1 else d)

    def meta(self, params: Mapping[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """Tensors of the whole shapes on the meta device, for an
        optimizer's ``init`` (which reads shapes only)."""
        return {n: torch.empty(self.shapes[n], dtype=p.dtype, device="meta")
                for n, p in params.items()}

    def _map(self, tree, fn, path: Tuple[str, ...] = ()):
        """``fn(tensor, its sharded dimension)`` over every tensor of an
        optimizer state."""
        if isinstance(tree, dict):
            return {k: self._map(v, fn, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return fn(tree, self.opt_leaf_dim(path))
        return tree

    def materialize(self, tree, device):
        """An optimizer state of meta tensors → zeros of this rank's
        slices on ``device``."""
        return self._map(tree, lambda t, dim: torch.zeros(
            self.local_shape(tuple(t.shape), dim), dtype=t.dtype,
            device=device))

    def local_tree(self, tree):
        """A whole optimizer state (a checkpoint's) → this rank's slices."""
        return self._map(tree, self.local)

    @torch.no_grad()
    def whole_state(self, state) -> Optional[dict]:
        """The checkpoint payload of a sharded ``TrainState``, whole on the
        CPU, as one process saves it: gathered by the ranks of rank 0's
        fsdp group, one tensor at a time → the payload there, None on the
        other ranks."""
        if 0 not in self.mesh.fsdp_ranks:
            return None
        return {
            "params": {n: (p if self.dims[n] is None
                           else self.gather(p, self.dims[n])).detach().cpu()
                       for n, p in state.params.items()},
            "buffers": {n: b.detach().cpu() for n, b in state.buffers.items()},
            "opt_state": self._map(state.opt_state, lambda t, dim: (
                t if dim is None else self.gather(t, dim)).cpu()),
            "step": int(state.step),
        }


def state_bytes(state) -> Dict[str, int]:
    """The bytes a rank holds of its masters and of its optimizer state."""
    def tree_bytes(tree) -> int:
        if isinstance(tree, dict):
            return sum(tree_bytes(v) for v in tree.values())
        if isinstance(tree, torch.Tensor):
            return tree.numel() * tree.element_size()
        return 0

    return {"masters": tree_bytes(dict(state.params)),
            "optimizer": tree_bytes(state.opt_state)}
