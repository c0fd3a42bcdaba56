"""Multi-process runtime over ``torch.distributed``.

Counterpart of ``specforge_tpu/parallel/multihost.py``. The JAX package runs
one process per host and one global program over all devices; the port runs
one process per rank (SPMD), as the reference SpecForge does:

- :func:`maybe_initialize_distributed` — env-driven
  ``torch.distributed.init_process_group`` (``SPECFORGE_COORDINATOR`` as
  ``host:port``, ``SPECFORGE_NUM_PROCESSES``, ``SPECFORGE_PROCESS_ID``); a
  no-op without the env. Before the group is made, every rank publishes its
  host and the cards it sees through the coordinator's store, and the
  transport rule of :func:`plan_transport` picks the backend and each
  rank's card from what all ranks published; the choice is logged.
- :func:`process_index` / :func:`process_count` / :func:`is_primary` — rank
  identity for the rank-0 IO (checkpoints, tracker, markers).
- :func:`barrier` — every rank waits; a no-op in one process.
- :func:`process_batch_blocks` / :func:`shard_refs_for_process` — this
  rank's rows of every global batch. Ranks of one (dp, fsdp) batch block
  (the sequence-parallel group) hold the SAME samples, each taking its own
  sequence chunk: ``specforge_tpu/parallel/multihost.py:146-150``.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
from collections import Counter
from dataclasses import asdict, dataclass
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger("specforge_tpu_torch.multihost")

#: how long a collective may wait for its peers before it raises
TIMEOUT = datetime.timedelta(minutes=10)

#: this process's device, once :func:`maybe_initialize_distributed` made
#: the group
_RANK_DEVICE: Optional[torch.device] = None


@dataclass(frozen=True)
class RankPlace:
    """What one rank publishes before the group is made: its host, its
    device type and the identities (UUIDs) of the cards it sees, in index
    order."""

    host: str
    device_type: str
    cards: Tuple[str, ...] = ()


def plan_transport(places: Sequence[RankPlace]
                   ) -> Tuple[str, List[Optional[int]]]:
    """The transport rule → (backend, each rank's card index).

    A rank's local rank and its host's local world are its order and count
    among the ranks of its host. A CUDA rank takes card ``local_rank`` when
    it sees at least as many cards as its host has ranks, and card 0 when
    it sees exactly one (a launcher that pins one card per process, or
    ranks that share one card); any other count raises. Then:

    - every rank on a card no other rank uses → ``"nccl"``;
    - every rank of each host on that host's one card → ``"gloo"`` over
      host copies (NCCL refuses two ranks on one GPU);
    - CPU ranks → ``"gloo"``.

    Anything else (some ranks sharing a card and others not, CPU and CUDA
    ranks mixed) raises: no layout falls back to another transport."""
    n = len(places)
    types = {p.device_type for p in places}
    if types == {"cpu"}:
        return "gloo", [None] * n
    if types != {"cuda"}:
        raise ValueError(f"ranks on mixed device types {sorted(types)}")
    per_host = Counter(p.host for p in places)
    seen: Counter = Counter()
    index: List[Optional[int]] = []
    for rank, p in enumerate(places):
        local, local_world = seen[p.host], per_host[p.host]
        seen[p.host] += 1
        if len(p.cards) >= local_world:
            index.append(local)
        elif len(p.cards) == 1:
            index.append(0)
        else:
            raise ValueError(
                f"rank {rank} on {p.host} sees {len(p.cards)} CUDA cards for "
                f"{local_world} ranks on its host: give each rank a card of "
                "its own, or make one card visible to all of them")
    chosen = [(p.host, p.cards[i]) for p, i in zip(places, index)]
    if len(set(chosen)) == n:
        return "nccl", index
    if all(len({c for c, p in zip(chosen, places) if p.host == host}) == 1
           for host in per_host):
        return "gloo", index
    raise ValueError(
        f"some ranks share a card and others do not ({chosen}): NCCL "
        "refuses the shared cards and host-staged gloo would slow the rest")


def _place(device: torch.device) -> RankPlace:
    if device.type != "cuda":
        return RankPlace(socket.gethostname(), device.type)
    cards = tuple(str(torch.cuda.get_device_properties(i).uuid)
                  for i in range(torch.cuda.device_count()))
    return RankPlace(socket.gethostname(), "cuda", cards)


def maybe_initialize_distributed(
    device: torch.device,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> torch.device:
    """Initialise the default process group when the multi-process env is
    present → this rank's device (``device`` itself in one process).

    Env fallbacks: SPECFORGE_COORDINATOR (``host:port``),
    SPECFORGE_NUM_PROCESSES, SPECFORGE_PROCESS_ID. Safe to call more than
    once. An initialisation failure raises: there is no silent fallback to
    one process or to another backend."""
    global _RANK_DEVICE
    if dist.is_initialized():
        if _RANK_DEVICE is not None:
            return _RANK_DEVICE
        # a group the caller made: its current card, or the CPU
        return (torch.device("cuda", torch.cuda.current_device())
                if device.type == "cuda" else device)
    coordinator_address = coordinator_address or os.environ.get(
        "SPECFORGE_COORDINATOR")
    if coordinator_address is None:
        return device
    world = num_processes or int(
        os.environ.get("SPECFORGE_NUM_PROCESSES", "1"))
    rank = (process_id if process_id is not None
            else int(os.environ.get("SPECFORGE_PROCESS_ID", "0")))
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside 0..{world - 1}")
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=TIMEOUT)
    store.set(f"specforge/place/{rank}", json.dumps(asdict(_place(device))))
    places = []
    for r in range(world):
        raw = json.loads(store.get(f"specforge/place/{r}"))
        places.append(RankPlace(raw["host"], raw["device_type"],
                                tuple(raw["cards"])))
    backend, cards = plan_transport(places)
    mine = device if cards[rank] is None else torch.device("cuda", cards[rank])
    if mine.type == "cuda":
        torch.cuda.set_device(mine)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    _RANK_DEVICE = mine
    shared = backend == "gloo" and mine.type == "cuda"
    (logger.warning if shared else logger.info)(
        "torch.distributed initialised: rank %d/%d on %s, transport %s (%s)",
        rank, world, mine, backend,
        "one card per rank" if backend == "nccl" else
        "the ranks share one card: host-staged gloo" if shared else
        "CPU ranks",
    )
    return mine


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def barrier(name: str = "") -> None:
    """Every rank waits here; a no-op in one process. ``name`` is for the
    log of a rank that waits."""
    if process_count() <= 1:
        return
    logger.debug("barrier %s", name)
    dist.barrier()


def process_batch_blocks(grid, proc_index: Optional[int] = None):
    """This rank's slice of the flattened ``(dp, fsdp)`` batch-block axis →
    ``(first_block, n_blocks_mine, n_blocks_total)``. A rank owns one
    block: ranks are laid out ``((dp·fsdp + f)·U + u)·R + r``
    (``parallel/mesh.py``), so the ranks of one block are its sequence
    group and hold the same samples."""
    rank = process_index() if proc_index is None else proc_index
    cfg = grid.config
    return (rank // (cfg.sp_ulysses * cfg.sp_ring), 1, cfg.dp * cfg.fsdp)


def shard_refs_for_process(
    refs: Sequence[Any],
    global_batch_size: int,
    *,
    proc_index: Optional[int] = None,
    proc_count: Optional[int] = None,
    grid=None,
) -> List[Any]:
    """Slice an ordered global ref list down to this rank's share.

    The global batch ``g`` covers refs ``[g*G, (g+1)*G)``; the rank owning
    batch block ``b`` of ``n`` receives rows ``[b*G/n, (b+1)*G/n)`` of
    every batch. A trailing partial global batch is dropped on every rank
    alike, so every rank runs the same number of steps (and collectives)."""
    n = proc_count if proc_count is not None else process_count()
    if n <= 1:
        return list(refs)
    if grid is not None:
        first, mine, total = process_batch_blocks(grid, proc_index)
    else:
        first = proc_index if proc_index is not None else process_index()
        mine, total = 1, n
    if global_batch_size % total != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {total} "
            "batch blocks (dp*fsdp)")
    per_block = global_batch_size // total
    start, local = first * per_block, mine * per_block
    n_batches = len(refs) // global_batch_size
    dropped = len(refs) - n_batches * global_batch_size
    if dropped:
        logger.info("shard_refs_for_process: dropping %d trailing refs "
                    "(partial global batch)", dropped)
    out: List[Any] = []
    for g in range(n_batches):
        base = g * global_batch_size + start
        out.extend(refs[base:base + local])
    return out


def transport() -> str:
    """The backend of the default group (``"nccl"`` or ``"gloo"``), or
    ``"local"`` in one process."""
    return dist.get_backend() if dist.is_initialized() else "local"


def shutdown() -> None:
    """Destroy the default process group, if this process made one."""
    global _RANK_DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE = None
