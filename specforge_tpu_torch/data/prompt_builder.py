"""Prompt-task preparation for online producers.

Counterpart of ``specforge_tpu/data/prompt_builder.py``.

Raw / preformatted / pre-tokenized JSONL records → JSON-safe PromptTask
payloads with deterministic, epoch-tagged ordering (reference:
specforge/data/prompt_builder.py:20-336). The online producer replays exactly
this plan after restarts, so sampling is keyed on (prompt_seed, epoch).
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Iterable, List, Optional

from specforge_tpu_torch.runtime.contracts import PromptTask


def _stable_id(payload: Dict[str, Any], index: int) -> str:
    digest = hashlib.sha1(
        json.dumps(payload, sort_keys=True).encode()
    ).hexdigest()[:12]
    return f"prompt-{index:06d}-{digest}"


def load_prompt_records(path: str) -> List[Dict[str, Any]]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def tokenize_prompt_records(
    records: List[Dict[str, Any]],
    tokenizer,
    template_name: str,
    max_length: int,
    *,
    train_only_last_turn: bool = False,
) -> List[Dict[str, Any]]:
    """Tokenize raw conversation records into producer payloads.

    Records that already carry ``input_ids`` pass through untouched
    (pre-tokenized mode); raw conversations are rendered with the chat
    template and get assistant-span loss masks — the reference producer's
    prepare_prompts tokenization (specforge/data/prompt_builder.py:20-336).
    Records with nothing supervised are dropped, like build_dataset."""
    from specforge_tpu_torch.data.parse import (
        build_parser_for_template,
        normalize_conversation,
    )

    parser = None
    out: List[Dict[str, Any]] = []
    for record in records:
        if "input_ids" in record:
            out.append(record)
            continue
        if parser is None:
            parser = build_parser_for_template(
                tokenizer, template_name,
                train_only_last_turn=train_only_last_turn,
            )
        sample = parser.parse(normalize_conversation(record), max_length)
        if sample.loss_mask.sum() == 0 or len(sample.input_ids) < 2:
            continue
        out.append({
            "input_ids": [int(t) for t in sample.input_ids],
            "loss_mask": [int(m) for m in sample.loss_mask],
        })
    return out


def prepare_prompt_tasks(
    records: Iterable[Dict[str, Any]],
    *,
    epoch: int = 0,
    prompt_seed: Optional[int] = None,
    shuffle: bool = True,
) -> List[PromptTask]:
    """Deterministic per-epoch plan: stable ids, keyed shuffle."""
    tasks = []
    for i, record in enumerate(records):
        payload = dict(record)
        tasks.append(
            PromptTask(
                prompt_id=_stable_id(payload, i), payload=payload, epoch=epoch
            )
        )
    if shuffle and prompt_seed is not None:
        import numpy as np

        order = np.random.default_rng(
            (prompt_seed, epoch)
        ).permutation(len(tasks))
        tasks = [tasks[i] for i in order]
    return tasks
