"""The rank grid and its process groups.

Counterpart of ``specforge_tpu/parallel/mesh.py``. The JAX package lays its
devices out as ``[dp, fsdp, sp_ulysses, sp_ring]`` (``build_mesh``:
``np.asarray(devices).reshape(...)``) and shards along the mesh axes inside
one program. The port runs one process per rank and keeps that order: rank
``((d·fsdp + f)·U + u)·R + r`` sits at mesh coordinates (d, f, u, r), with
``U = sp_ulysses`` and ``R = sp_ring``. The groups a rank needs:

- the **Ulysses group**: the ranks that differ only in u (they exchange
  heads for sequence, ``all_to_all``);
- the **ring group**: the ranks that differ only in r (the K/V chunks
  rotate around it);
- the **fsdp group**: the ranks that differ only in f (they hold the shards
  of one tensor: all-gather of the weights, reduce-scatter of the
  gradients);
- the **replica group**: the ranks that hold the same shard, so differ in
  d, u or r (the reduce-scattered gradients are summed over it).

Every rank holds a different (batch block, sequence chunk) of the global
batch, so the loss and metric sums, and the sums of the gradients that
stay whole, run over all ranks, the default group
(``parallel/usp.py:mesh_sum``): there is no group of a batch block or of a
sequence chunk to sum over.

USP shards the sequence over ``(sp_ring, sp_ulysses)``, ring-major
(``specforge_tpu/parallel/usp.py:272``): rank (u, r) holds sequence chunk
``r·U + u``. The batch rides ``(dp, fsdp)``: the rank of batch block
``d·fsdp + f`` loads that block's rows of every global batch
(``multihost.shard_refs_for_process``). Parameters follow
:func:`param_partition_spec`, the JAX package's rule: the largest
dimension divisible by ``fsdp`` carries the shard, and a tensor below
``MIN_SHARD_BYTES`` or with no such dimension stays whole
(``parallel/fsdp.py`` keeps and moves the shards).
"""

from __future__ import annotations

import itertools
import logging
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from specforge_tpu_torch.parallel.multihost import transport

logger = logging.getLogger("specforge_tpu_torch.mesh")

MESH_AXES = ("dp", "fsdp", "sp_ulysses", "sp_ring")

#: a tensor smaller than this stays whole on every rank
#: (``specforge_tpu/parallel/mesh.py:35``)
MIN_SHARD_BYTES = 2 ** 18


def param_partition_spec(shape: Sequence[int], itemsize: int, fsdp: int,
                         min_shard_bytes: int = MIN_SHARD_BYTES
                         ) -> Optional[int]:
    """The dimension of a tensor of ``shape`` that carries the fsdp shard,
    or None for a tensor kept whole: the largest dimension divisible by
    ``fsdp`` (the last of equal ones), as ``param_partition_spec`` of
    ``specforge_tpu/parallel/mesh.py:69-89`` puts ``"fsdp"`` there."""
    shape = tuple(shape)
    if fsdp <= 1 or not shape:
        return None
    if math.prod(shape) * itemsize < min_shard_bytes:
        return None
    candidates = [(n, i) for i, n in enumerate(shape) if n % fsdp == 0]
    return max(candidates)[1] if candidates else None


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = 1
    sp_ulysses: int = 1
    sp_ring: int = 1

    @property
    def world_size(self) -> int:
        return self.dp * self.fsdp * self.sp_ulysses * self.sp_ring

    @property
    def shape(self) -> Tuple[int, int, int, int]:
        return (self.dp, self.fsdp, self.sp_ulysses, self.sp_ring)

    def coords(self, rank: int) -> Tuple[int, int, int, int]:
        """Mesh coordinates (d, f, u, r) of ``rank``."""
        out = []
        for size in reversed(self.shape):
            out.append(rank % size)
            rank //= size
        return tuple(reversed(out))

    def rank_of(self, d: int, f: int, u: int, r: int) -> int:
        return ((d * self.fsdp + f) * self.sp_ulysses + u) * self.sp_ring + r

    @property
    def batch_blocks(self) -> int:
        """The number of blocks the global batch is cut into: dp·fsdp."""
        return self.dp * self.fsdp


@dataclass
class Mesh:
    """This rank's place in the grid and its groups. ``transport`` is the
    default group's backend, ``"nccl"`` or ``"gloo"``
    (``multihost.plan_transport``); the groups are None in one process."""

    config: MeshConfig
    rank: int
    device: torch.device
    transport: str
    ulysses_group: Optional[dist.ProcessGroup] = None
    ring_group: Optional[dist.ProcessGroup] = None
    fsdp_group: Optional[dist.ProcessGroup] = None
    replica_group: Optional[dist.ProcessGroup] = None
    ring_ranks: Tuple[int, ...] = ()
    fsdp_ranks: Tuple[int, ...] = ()

    @property
    def world_size(self) -> int:
        return self.config.world_size

    @property
    def ulysses_rank(self) -> int:
        return self.config.coords(self.rank)[2]

    @property
    def ring_rank(self) -> int:
        return self.config.coords(self.rank)[3]

    @property
    def ulysses_size(self) -> int:
        return self.config.sp_ulysses

    @property
    def ring_size(self) -> int:
        return self.config.sp_ring

    @property
    def sp_size(self) -> int:
        return self.config.sp_ulysses * self.config.sp_ring

    @property
    def chunk_index(self) -> int:
        """The sequence chunk this rank holds: ``r·U + u``."""
        return self.ring_rank * self.ulysses_size + self.ulysses_rank

    @property
    def fsdp_rank(self) -> int:
        return self.config.coords(self.rank)[1]

    @property
    def fsdp_size(self) -> int:
        return self.config.fsdp

    @property
    def batch_block(self) -> Tuple[int, int]:
        """(this rank's batch block ``d·fsdp + f``, the number of blocks)."""
        d, f = self.config.coords(self.rank)[:2]
        return d * self.config.fsdp + f, self.config.batch_blocks


def _groups(config: MeshConfig, vary: Tuple[int, ...]) -> List[List[int]]:
    """Every group of ranks whose coordinates differ only on the axes in
    ``vary`` (indices into MESH_AXES), each sorted, in a fixed order."""
    fixed = [i for i in range(4) if i not in vary]
    out = []
    for outer in itertools.product(*(range(config.shape[i]) for i in fixed)):
        ranks = []
        for inner in itertools.product(*(range(config.shape[i])
                                         for i in vary)):
            c = [0] * 4
            for i, x in zip(fixed, outer):
                c[i] = x
            for i, x in zip(vary, inner):
                c[i] = x
            ranks.append(config.rank_of(*c))
        out.append(sorted(ranks))
    return out


def build_mesh(config: MeshConfig, device: torch.device) -> Mesh:
    """This rank's :class:`Mesh` over the default process group (one
    process: a mesh of one rank without groups). Every rank calls this with
    the same config: each group is created by all ranks in one order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if config.world_size != world:
        raise ValueError(
            f"mesh {config} needs {config.world_size} ranks, have {world}")
    if world == 1:
        return Mesh(config, 0, device, "local", fsdp_ranks=(0,))
    rank = dist.get_rank()
    mesh = Mesh(config, rank, device, transport())
    for attr, vary in (("ulysses_group", (2,)), ("ring_group", (3,)),
                       ("fsdp_group", (1,)), ("replica_group", (0, 2, 3))):
        for ranks in _groups(config, vary):
            group = dist.new_group(ranks)
            if rank in ranks:
                setattr(mesh, attr, group)
                if attr == "ring_group":
                    mesh.ring_ranks = tuple(ranks)
                elif attr == "fsdp_group":
                    mesh.fsdp_ranks = tuple(ranks)
    logger.info("mesh %s: rank %d at %s, batch block %d, sequence chunk %d, "
                "transport %s", dict(zip(MESH_AXES, config.shape)), rank,
                config.coords(rank), mesh.batch_block[0], mesh.chunk_index,
                mesh.transport)
    return mesh
