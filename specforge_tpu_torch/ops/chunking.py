"""Checkpointed chunk reduction.

Counterpart of ``specforge_tpu/ops/chunking.py``: an additive-terms
reduction over slices of an anchor axis, each slice under activation
checkpointing (``torch.utils.checkpoint``), so its large intermediates (the
[chunk · block, vocab] logits of the unfused DFlash-family objectives) are
recomputed in the backward pass instead of stored. Chunks must tile the
axis exactly.
"""

from __future__ import annotations

from typing import Callable

from torch.utils.checkpoint import checkpoint


def checkpointed_chunk_reduce(fn: Callable, *arrays, chunk_size: int,
                              axis: int = 1):
    """Sum ``fn(*chunked_arrays)`` (a tuple of additive terms) over chunks
    of ``axis``. ``chunk_size`` 0 (or at least the axis) disables chunking;
    ``None`` arrays pass through as ``None``."""
    sizes = {a.shape[axis] for a in arrays if a is not None}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent chunk-axis sizes: {sizes}")
    n = sizes.pop()
    if chunk_size <= 0 or chunk_size >= n:
        return fn(*arrays)
    if n % chunk_size != 0:
        raise ValueError(
            f"chunk_size {chunk_size} must divide axis size {n}; pad with "
            "zero-weight blocks"
        )
    totals = None
    for start in range(0, n, chunk_size):
        chunks = [None if a is None else a.narrow(axis, start, chunk_size)
                  for a in arrays]
        terms = checkpoint(fn, *chunks, use_reentrant=False)
        totals = terms if totals is None else tuple(
            t + u for t, u in zip(totals, terms))
    return totals
