"""Batch-size-invariant evaluator.

Counterpart of ``specforge_tpu/eval/evaluator.py``. Per-position correct and
denominator counts and acceptance numerators/denominators are summed over
the whole eval set, in float64 on the host, before any division; the
headline metric is

    eval/simulated_acc_len = Σ_i Π_{j ≤ i} a_j

with a_j the set-wide per-TTT-position acceptance rates. On a mesh every
rank evaluates its own block of each global batch, and the model sums each
batch's numerators and denominators over the ranks (``mesh_sum``), so every
rank accumulates the global batch's values: the same sums, the same metrics
and the same number of batches on every rank (``shard_refs_for_process``
drops a trailing partial global batch everywhere).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from specforge_tpu_torch.runtime.contracts import TrainBatch


class Evaluator:
    def __init__(self, strategy, metadata: Optional[Dict[str, Any]] = None):
        self.strategy = strategy
        self.metadata = dict(metadata or {})

    @torch.no_grad()
    def run(
        self, batches: Iterable[TrainBatch], frozen: Dict[str, Any],
        params: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, float]:
        """Evaluate the strategy's model (on its device) over ``batches``;
        ``params`` stand in for the model's own (the whole weights gathered
        from their fsdp shards)."""
        sums: Dict[str, np.ndarray] = {}
        n_batches = 0
        for batch in batches:
            metadata = {**self.metadata, **batch.metadata}
            out = self.strategy.eval_outputs(batch.tensors, frozen, metadata,
                                             params=params)
            for key, value in out.items():
                value = value.double().cpu().numpy()
                sums[key] = value if key not in sums else sums[key] + value
            n_batches += 1
        if n_batches == 0:
            return {}

        metrics: Dict[str, float] = {}
        accs = sums["corrects"] / np.maximum(sums["denoms"], 1e-6)
        rates = sums["acc_nums"] / np.maximum(sums["acc_dens"], 1e-8)
        plosses = sums["loss_sums"] / np.maximum(sums["loss_dens"], 1e-6)
        for i in range(len(accs)):
            metrics[f"eval/acc_{i}"] = float(accs[i])
            metrics[f"eval/acceptance_rate_{i}"] = float(rates[i])
            metrics[f"eval/ploss_{i}"] = float(plosses[i])
        metrics["eval/simulated_acc_len"] = float(np.sum(np.cumprod(rates)))
        return metrics
