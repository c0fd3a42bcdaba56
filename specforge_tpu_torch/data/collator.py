"""Batch collation with static shapes.

Counterpart of ``specforge_tpu/data/collator.py``: ``PaddingCollator`` pads
(or truncates) every sample to a fixed ``max_length``; ``PackingCollator``
packs many short documents into a fixed number of rows (P-EAGLE). Feature
conventions (EAGLE3 offline layout): ``input_ids`` [S], ``loss_mask`` [S] or
[S, 1], ``hidden_state`` [S, 3H] aux concat, ``target`` [S, H] last hidden.
``attention_mask`` is derived from the true length when absent. Stored
floating dtypes (bf16 captures) are kept unless ``cast_float_dtype`` names
another.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from specforge_tpu_torch.runtime.contracts import TrainBatch


@dataclass(frozen=True)
class CollatorConfig:
    max_length: int
    pad_token_id: int = 0
    #: cast floating features to this dtype name on the host (None = keep)
    cast_float_dtype: Optional[str] = None


@dataclass(frozen=True)
class PackingCollatorConfig:
    """COD sequence packing (P-EAGLE): every batch is exactly ``rows`` rows
    of ``max_length`` with a ``lengths`` [rows, max_docs_per_row] vector of
    document lengths (0-padded), from which the COD sampler and mask derive
    per-position document ids."""

    max_length: int
    #: number of packed rows per batch (the model's batch size)
    rows: int
    max_docs_per_row: int = 8
    pad_token_id: int = 0
    cast_float_dtype: Optional[str] = None


def _pad_to(x: torch.Tensor, length: int, pad_value=0) -> torch.Tensor:
    s = x.shape[0]
    if s >= length:
        return x[:length]
    pad = [0, 0] * (x.dim() - 1) + [0, length - s]
    return F.pad(x, pad, value=pad_value)


def _pad_position_ids(x: torch.Tensor, length: int) -> torch.Tensor:
    """[S] rope or [3, S] mrope (vision) position ids, padded with 0 (or
    cut) on the sequence (last) axis; stacked batch-first, [B, 3, S], and
    the model moves the axis to rope's [3, B, S]."""
    x = x.to(torch.int32)
    if x.dim() == 1:
        return _pad_to(x, length)
    if x.dim() != 2 or x.shape[0] != 3:
        raise ValueError(
            f"position_ids must be [S] or [3, S], got {tuple(x.shape)}")
    return _pad_to(x.T, length).T.contiguous()


def position_ids_seq_second(x: torch.Tensor) -> torch.Tensor:
    """Batched position ids with the sequence on the second axis, as every
    other batch tensor has it: mrope's [B, 3, S] → [B, S, 3]; [B, S] ids as
    they are. :func:`position_ids_from_seq_second` undoes it."""
    return x.movedim(1, 2) if x.dim() == 3 else x


def position_ids_from_seq_second(x: torch.Tensor) -> torch.Tensor:
    """[B, S, 3] → the collator's [B, 3, S]; [B, S] ids as they are."""
    return x.movedim(2, 1) if x.dim() == 3 else x


class PaddingCollator:
    """List of per-sample tensor dicts → TrainBatch of [B, max_length, ...]."""

    def __init__(self, config: CollatorConfig):
        self.config = config

    def __call__(
        self,
        samples: Sequence[Mapping[str, torch.Tensor]],
        sample_ids: Optional[Sequence[str]] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> TrainBatch:
        L = self.config.max_length
        batch: Dict[str, List[torch.Tensor]] = {}
        lengths = []
        for sample in samples:
            lengths.append(min(sample["input_ids"].numel(), L))
            for name, value in sample.items():
                x = torch.as_tensor(value)
                if name == "input_ids":
                    x = _pad_to(x.reshape(-1).to(torch.int32), L,
                                self.config.pad_token_id)
                elif name == "loss_mask":
                    x = _pad_to(x.reshape(x.shape[0], -1)[:, 0].to(torch.int32),
                                L)
                elif name == "attention_mask":
                    x = _pad_to(x.reshape(-1).to(torch.int32), L)
                elif name == "position_ids":
                    x = _pad_position_ids(x, L)
                elif x.dim() == 1:
                    x = _pad_to(x, L)
                else:
                    x = _pad_to(x.reshape(x.shape[0], -1), L)
                batch.setdefault(name, []).append(x)
        if "attention_mask" not in batch:
            masks = []
            for n in lengths:
                m = torch.zeros(L, dtype=torch.int32)
                m[:n] = 1
                masks.append(m)
            batch["attention_mask"] = masks

        cast = self.config.cast_float_dtype
        stacked = {}
        for name, xs in batch.items():
            out = torch.stack(xs)
            if cast and out.is_floating_point():
                out = out.to(getattr(torch, cast))
            stacked[name] = out
        if "loss_mask" in stacked and stacked["loss_mask"].dim() == 2:
            stacked["loss_mask"] = stacked["loss_mask"][..., None]
        return TrainBatch(
            tensors=stacked,
            sample_ids=list(sample_ids or []),
            metadata=dict(metadata or {}),
        )


class PackingCollator:
    """Packs documents into ``rows`` rows for COD training, as the JAX
    package's ``PackingCollator`` does.

    Longest-processing-time placement: documents sorted by length go to the
    least-loaded row that still has room (and a free document slot). A
    document that fits nowhere is truncated into the largest remaining gap
    (``metadata["packing"]["truncated_tokens"]``), or dropped when that gap
    is a token or less. The last position of every document is loss-masked:
    the offline teacher shift supervises position p with token p + 1, which
    at a document boundary belongs to the next document. Two behaviours of
    the JAX collator are kept for parity: truncated tokens are counted from
    the length already cut to ``max_length``, and ``sample_ids`` list every
    document handed in, dropped ones too."""

    def __init__(self, config: PackingCollatorConfig):
        self.config = config

    @staticmethod
    def _doc_length(sample: Mapping[str, torch.Tensor]) -> int:
        if "attention_mask" in sample:
            return int(torch.as_tensor(sample["attention_mask"]).sum())
        return torch.as_tensor(sample["input_ids"]).numel()

    def _place(self, doc_lens: List[int]):
        """→ (documents per row in arrival order, tokens taken per document,
        row loads, truncated tokens, dropped documents)."""
        cfg = self.config
        L = cfg.max_length
        order = sorted(range(len(doc_lens)), key=lambda i: doc_lens[i],
                       reverse=True)
        row_load = [0] * cfg.rows
        row_docs: List[List[int]] = [[] for _ in range(cfg.rows)]
        take_len = list(doc_lens)
        truncated = dropped = 0
        for i in order:
            n = doc_lens[i]
            open_rows = [r for r in range(cfg.rows)
                         if len(row_docs[r]) < cfg.max_docs_per_row]
            fits = [r for r in open_rows if row_load[r] + n <= L]
            if fits:
                r = min(fits, key=lambda r: row_load[r])
            elif open_rows:
                r = min(open_rows, key=lambda r: row_load[r])
                gap = L - row_load[r]
                if gap <= 1:
                    dropped += 1
                    continue
                truncated += n - gap
                take_len[i] = gap
            else:
                dropped += 1
                continue
            row_docs[r].append(i)
            row_load[r] += take_len[i]
        for docs in row_docs:
            # arrival order inside a row: packing is deterministic under the
            # loader's ordered prefetch
            docs.sort()
        return row_docs, take_len, row_load, truncated, dropped

    def __call__(
        self,
        samples: Sequence[Mapping[str, torch.Tensor]],
        sample_ids: Optional[Sequence[str]] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> TrainBatch:
        cfg = self.config
        L = cfg.max_length
        doc_lens = [min(self._doc_length(s), L) for s in samples]
        row_docs, take_len, row_load, truncated, dropped = self._place(
            doc_lens)
        lengths = torch.zeros((cfg.rows, cfg.max_docs_per_row),
                              dtype=torch.int32)
        attention_mask = torch.zeros((cfg.rows, L), dtype=torch.int32)
        for r, docs in enumerate(row_docs):
            for slot, i in enumerate(docs):
                lengths[r, slot] = take_len[i]
            attention_mask[r, :row_load[r]] = 1

        names = [n for n in (samples[0] if samples else {})
                 if n not in ("attention_mask", "position_ids")]
        tensors: Dict[str, torch.Tensor] = {}
        for name in names:
            rows = []
            for docs in row_docs:
                parts = []
                for i in docs:
                    x = torch.as_tensor(samples[i][name])
                    if name == "input_ids":
                        x = x.reshape(-1).to(torch.int32)
                    elif name == "loss_mask":
                        x = x.reshape(x.shape[0], -1)[:, 0].to(torch.int32)
                    elif x.dim() > 1:
                        x = x.reshape(x.shape[0], -1)
                    x = x[:take_len[i]]
                    if name == "loss_mask" and x.shape[0] > 0:
                        # the boundary's label is the next document's token
                        x = x.clone()
                        x[-1] = 0
                    parts.append(x)
                if parts:
                    row = torch.cat(parts, dim=0)
                else:
                    proto = torch.as_tensor(samples[0][name])
                    shape = (0,) if proto.dim() == 1 else (
                        0, math.prod(proto.shape[1:]))
                    row = torch.zeros(shape, dtype=proto.dtype)
                pad = cfg.pad_token_id if name == "input_ids" else 0
                rows.append(_pad_to(row, L, pad))
            out = torch.stack(rows)
            if cfg.cast_float_dtype and out.is_floating_point():
                out = out.to(getattr(torch, cfg.cast_float_dtype))
            tensors[name] = out
        tensors["attention_mask"] = attention_mask
        tensors["lengths"] = lengths
        if "loss_mask" in tensors and tensors["loss_mask"].dim() == 2:
            tensors["loss_mask"] = tensors["loss_mask"][..., None]
        meta = dict(metadata or {})
        meta["packing"] = {"docs": len(samples) - dropped,
                           "dropped_docs": dropped,
                           "truncated_tokens": truncated}
        return TrainBatch(tensors=tensors, sample_ids=list(sample_ids or []),
                          metadata=meta)
