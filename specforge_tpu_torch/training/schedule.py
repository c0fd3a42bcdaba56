"""Training-schedule resolution.

Counterpart of ``specforge_tpu/training/schedule.py``: optimizer steps per
epoch and over the run, and the up-front refusal of plans whose
accumulation windows would be partial.
"""

from __future__ import annotations


def steps_per_epoch(
    samples_per_rank: int, batch_size: int, accum_steps: int
) -> int:
    batches = samples_per_rank // batch_size
    return batches // accum_steps


def resolve_total_steps(
    samples_per_rank: int,
    batch_size: int,
    accum_steps: int,
    num_epochs: int,
) -> int:
    """Optimizer steps over the full run: floor per epoch (partial accumulation
    windows are rejected up-front, never silently shortened)."""
    per_epoch = steps_per_epoch(samples_per_rank, batch_size, accum_steps)
    if per_epoch <= 0:
        raise ValueError(
            f"not enough samples for one optimizer step: samples_per_rank="
            f"{samples_per_rank}, batch_size={batch_size}, accum={accum_steps}"
        )
    return per_epoch * num_epochs


def validate_fixed_accumulation_plan(
    samples_per_rank: int, batch_size: int, accum_steps: int
) -> None:
    """Reject plans whose final accumulation window would be partial."""
    if steps_per_epoch(samples_per_rank, batch_size, accum_steps) == 0:
        raise ValueError(
            "accumulation plan yields zero optimizer steps per epoch "
            f"(samples_per_rank={samples_per_rank}, batch={batch_size}, "
            f"accum={accum_steps})"
        )
