"""Draft-vocab mapping (t2d/d2t): derivation and file IO.

Counterpart of ``specforge_tpu/training/vocab_mapping.py``. The draft
vocabulary is the ``draft_vocab_size`` most frequent target tokens over the
offline corpus (ties broken by lower token id), kept in ascending token-id
order. The file is an ``.npz`` with ``t2d`` (bool [vocab], draft
membership) and ``d2t`` (int32 [draft_vocab], target_id = draft_id +
d2t[draft_id]).
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np


def derive_vocab_mapping(
    token_id_streams: Iterable[np.ndarray],
    vocab_size: int,
    draft_vocab_size: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Count token frequencies over the corpus → (t2d bool [V], d2t int32 [Vd])."""
    counts = np.zeros(vocab_size, np.int64)
    for ids in token_id_streams:
        ids = np.asarray(ids).reshape(-1)
        ids = ids[(ids >= 0) & (ids < vocab_size)]
        counts += np.bincount(ids, minlength=vocab_size)
    if draft_vocab_size > vocab_size:
        raise ValueError(
            f"draft_vocab_size {draft_vocab_size} > vocab_size {vocab_size}"
        )
    # stable top-k on (-count, id); lexsort keys are last-primary
    order = np.lexsort((np.arange(vocab_size), -counts))
    keep = np.sort(order[:draft_vocab_size])
    t2d = np.zeros(vocab_size, bool)
    t2d[keep] = True
    d2t = (keep - np.arange(draft_vocab_size)).astype(np.int32)
    return t2d, d2t


def derive_from_offline_dir(
    data_dir: str, vocab_size: int, draft_vocab_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Derive the mapping from the input_ids of every offline feature file."""
    from specforge_tpu_torch.runtime.data_plane.feature_file import (
        load_feature_file,
    )
    from specforge_tpu_torch.runtime.data_plane.offline_reader import (
        OfflineManifestReader,
    )

    def streams():
        for path in OfflineManifestReader(data_dir).list_files():
            tensors, _ = load_feature_file(path)
            if "input_ids" in tensors:
                yield tensors["input_ids"].numpy()

    return derive_vocab_mapping(streams(), vocab_size, draft_vocab_size)


def save_vocab_mapping(path: str, t2d, d2t) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, t2d=np.asarray(t2d, bool), d2t=np.asarray(d2t, np.int32))
    os.replace(tmp, path)


def load_vocab_mapping(path: str) -> Tuple[np.ndarray, np.ndarray]:
    data = np.load(path)
    return data["t2d"].astype(bool), data["d2t"].astype(np.int32)
