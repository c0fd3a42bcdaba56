"""Checkpoint manager: ``torch.save`` state + a validated resume contract.

Counterpart of ``specforge_tpu/training/checkpoint.py``, with the same names
and layout; the orbax pytree becomes one ``torch.save`` file:

    {output_dir}/{run_id}-step{N}/state/state.pt  — trainable fp32 masters,
                                                    buffers, optimizer state
                                                    (dense, factored and
                                                    row-sparse moments as
                                                    the optimizer keeps
                                                    them), step
    {output_dir}/{run_id}-step{N}/contract.json   — resume contract + progress
    {output_dir}/{run_id}.latest                  — step number of newest save
    {output_dir}/{run_id}.best_meta.json          — best eval metric + step

Resume validates the contract (strategy, global batch, accum/total steps,
model fingerprints) and refuses a silently divergent resume; the world
size is recorded but not compared, since the files are the same whatever
the topology that wrote them.
Rotation keeps ``max_checkpoints`` newest, never deleting the best. The
payload holds only tensors, numbers and dicts, and is read back with
``weights_only=True``. One process writes it: in a multi-process run the
ranks of a replica group hold the same state (the train step sums the
gradients over all ranks before the step), and under fsdp rank 0's fsdp
group gathers each sharded tensor whole (``gather``), so the primary rank
writes the files a one-process run writes and the markers between two
barriers, and every rank reads them on resume (its slices under fsdp).
``save_contract`` rewrites only a step's ``contract.json`` and the markers,
for a run whose state at that step is on disk already (an interval's
checkpoint that falls on the epoch's end).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

BEST_METRIC = "eval/simulated_acc_len"
STATE_FILE = "state.pt"


@dataclass(frozen=True)
class ResumeContract:
    """Everything that must match between the saving and resuming runs."""

    strategy: str
    world_size: int
    train_batch_size: int
    accum_steps: int
    total_steps: int
    run_id: str
    draft_config_fingerprint: str = ""
    model_fingerprints: Dict[str, str] = field(default_factory=dict)
    step_options: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "ResumeContract":
        return cls(**{f.name: obj[f.name] for f in dataclasses.fields(cls)
                      if f.name in obj})

    def validate_against(
        self, saved: "ResumeContract", *, ignore: Tuple[str, ...] = ()
    ) -> None:
        mismatches: List[str] = []
        for f in dataclasses.fields(self):
            if f.name in ignore:
                continue
            mine, theirs = getattr(self, f.name), getattr(saved, f.name)
            if mine != theirs:
                mismatches.append(f"{f.name}: saved={theirs!r} current={mine!r}")
        if mismatches:
            raise ValueError(
                "resume contract mismatch — refusing to resume:\n  "
                + "\n  ".join(mismatches)
            )


@dataclass
class Progress:
    """Mid-epoch position, persisted in SAMPLES so resume is batch-size
    independent."""

    epoch: int = 0
    samples_consumed: int = 0
    global_step: int = 0

    def to_json(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj):
        return cls(**obj)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


class CheckpointManager:
    def __init__(
        self,
        output_dir: str,
        run_id: str,
        *,
        max_checkpoints: int = 5,
        primary: bool = True,
        barrier_fn: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.output_dir = os.path.abspath(output_dir)
        self.run_id = run_id
        self.max_checkpoints = max_checkpoints
        self.primary = primary
        self._barrier = barrier_fn or (lambda name: None)
        if primary:
            os.makedirs(self.output_dir, exist_ok=True)

    # --- paths ----------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.output_dir, f"{self.run_id}-step{step}")

    def _latest_marker(self) -> str:
        return os.path.join(self.output_dir, f"{self.run_id}.latest")

    def _best_meta_path(self) -> str:
        return os.path.join(self.output_dir, f"{self.run_id}.best_meta.json")

    # --- save -----------------------------------------------------------
    def save(
        self,
        state,
        step: int,
        contract: ResumeContract,
        progress: Progress,
        metrics: Optional[Dict[str, float]] = None,
        gather: Optional[Callable[[Any], Optional[Dict[str, Any]]]] = None,
    ) -> str:
        """Write ``state`` (a TrainState) under ``{run_id}-step{step}``:
        the primary writes, every rank waits for it. ``gather(state)``,
        called on every rank, gives the whole payload of a sharded state
        (on the primary)."""
        step_dir = self.step_dir(step)
        self._barrier(f"ckpt-pre-{step}")
        payload = gather(state) if gather is not None else None
        if self.primary:
            self._write_state(state, step, payload)
            self._write_meta(step, contract, progress, metrics)
        self._barrier(f"ckpt-post-{step}")
        return step_dir

    def save_contract(
        self,
        step: int,
        contract: ResumeContract,
        progress: Progress,
        metrics: Optional[Dict[str, float]] = None,
    ) -> str:
        """Rewrite only the contract, progress and metrics of step
        ``step``, whose state this run has written: the primary writes,
        every rank waits for it."""
        self._barrier(f"ckpt-contract-pre-{step}")
        if self.primary:
            self._write_meta(step, contract, progress, metrics)
        self._barrier(f"ckpt-contract-post-{step}")
        return self.step_dir(step)

    def _write_state(self, state, step, payload=None) -> None:
        step_dir = self.step_dir(step)
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        state_dir = os.path.join(step_dir, "state")
        os.makedirs(state_dir)
        if payload is None:
            payload = _to_cpu({
                "params": dict(state.params),
                "buffers": dict(state.buffers),
                "opt_state": state.opt_state,
                "step": int(state.step),
            })
        tmp = os.path.join(state_dir, STATE_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(state_dir, STATE_FILE))

    def _write_meta(self, step, contract, progress, metrics) -> None:
        step_dir = self.step_dir(step)
        meta = {
            "contract": contract.to_json(),
            "progress": progress.to_json(),
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        tmp = os.path.join(step_dir, "contract.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, os.path.join(step_dir, "contract.json"))
        with open(self._latest_marker() + ".tmp", "w") as f:
            f.write(str(step))
        os.replace(self._latest_marker() + ".tmp", self._latest_marker())
        self._rotate()

    def _existing_steps(self) -> List[int]:
        steps = []
        prefix = f"{self.run_id}-step"
        if not os.path.isdir(self.output_dir):  # the primary makes it
            return steps
        for name in os.listdir(self.output_dir):
            if name.startswith(prefix):
                tail = name[len(prefix):]
                if tail.isdigit():
                    steps.append(int(tail))
        return sorted(steps)

    def _rotate(self) -> None:
        if self.max_checkpoints <= 0:
            return
        steps = self._existing_steps()
        best_step = self.best_step()
        removable = [s for s in steps if s != best_step]
        while len(steps) > self.max_checkpoints and removable:
            victim = removable.pop(0)
            steps.remove(victim)
            shutil.rmtree(self.step_dir(victim), ignore_errors=True)

    # --- best tracking --------------------------------------------------
    def best_step(self) -> Optional[int]:
        try:
            with open(self._best_meta_path()) as f:
                return int(json.load(f)["step"])
        except (FileNotFoundError, KeyError, ValueError):
            return None

    def maybe_update_best(self, step: int, metrics: Dict[str, float]) -> bool:
        """Record ``step`` as best if its metric (higher is better) beats
        the stored one."""
        if BEST_METRIC not in metrics or not self.primary:
            return False
        value = float(metrics[BEST_METRIC])
        current: Optional[float] = None
        try:
            with open(self._best_meta_path()) as f:
                current = float(json.load(f)["value"])
        except (FileNotFoundError, KeyError, ValueError):
            pass
        better = current is None or value > current
        if better:
            tmp = self._best_meta_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {"step": step, "metric": BEST_METRIC, "value": value},
                    f,
                )
            os.replace(tmp, self._best_meta_path())
        return better

    # --- restore --------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        try:
            with open(self._latest_marker()) as f:
                return int(f.read().strip())
        except (FileNotFoundError, ValueError):
            steps = self._existing_steps()
            return steps[-1] if steps else None

    def read_saved_contract(
        self, step: int
    ) -> Tuple[ResumeContract, Progress, Dict[str, float]]:
        with open(os.path.join(self.step_dir(step), "contract.json")) as f:
            payload = json.load(f)
        return (
            ResumeContract.from_json(payload["contract"]),
            Progress.from_json(payload["progress"]),
            payload.get("metrics", {}),
        )

    @staticmethod
    def resolve_step_dir(checkpoint: str) -> str:
        """An explicit checkpoint target → its step dir: a step dir (holds
        ``state/``) or a run root with exactly ONE run's ``*.latest``
        marker. A root holding several runs is ambiguous and refused."""
        checkpoint = os.path.abspath(checkpoint)
        if os.path.isdir(os.path.join(checkpoint, "state")):
            return checkpoint
        resolved = []
        for marker in sorted(os.listdir(checkpoint)):
            if not marker.endswith(".latest"):
                continue
            run_id = marker[: -len(".latest")]
            with open(os.path.join(checkpoint, marker)) as f:
                step = int(f.read().strip())
            step_dir = os.path.join(checkpoint, f"{run_id}-step{step}")
            if os.path.isdir(step_dir):
                resolved.append(step_dir)
        if len(resolved) > 1:
            raise ValueError(
                f"{checkpoint} holds {len(resolved)} runs "
                f"({', '.join(os.path.basename(d) for d in resolved)}); "
                "point at one step dir explicitly"
            )
        if resolved:
            return resolved[0]
        raise FileNotFoundError(
            f"no checkpoint under {checkpoint} (expected a step dir with "
            "state/ or a run root with a .latest marker)"
        )

    @staticmethod
    def load_state(step_dir: str) -> Dict[str, Any]:
        """The saved payload (CPU tensors) of a step dir."""
        return torch.load(os.path.join(step_dir, "state", STATE_FILE),
                          map_location="cpu", weights_only=True)

    def restore_path(
        self,
        step_dir: str,
        contract: Optional[ResumeContract] = None,
    ):
        """Read an explicit step dir (training.resume_from) → (payload,
        progress, metrics); the run identity may differ, everything else
        in the contract must match."""
        with open(os.path.join(step_dir, "contract.json")) as f:
            meta = json.load(f)
        if contract is not None:
            contract.validate_against(
                ResumeContract.from_json(meta["contract"]),
                ignore=("run_id", "world_size"))
        return (self.load_state(step_dir), Progress.from_json(meta["progress"]),
                meta.get("metrics", {}))

    def restore(
        self,
        step: int,
        contract: Optional[ResumeContract] = None,
    ):
        """Read this run's step ``step`` → (payload, progress, metrics),
        validating the resume contract when given."""
        saved_contract, progress, metrics = self.read_saved_contract(step)
        if contract is not None:
            contract.validate_against(saved_contract, ignore=("world_size",))
        return self.load_state(self.step_dir(step)), progress, metrics
