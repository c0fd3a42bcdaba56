"""Draft-vocab mapping (t2d/d2t) file IO.

Counterpart of ``save_vocab_mapping``/``load_vocab_mapping`` in
``specforge_tpu/training/vocab_mapping.py``: an ``.npz`` with ``t2d`` (bool
[vocab], draft membership) and ``d2t`` (int32 [draft_vocab], target_id =
draft_id + d2t[draft_id]).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def save_vocab_mapping(path: str, t2d, d2t) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, t2d=np.asarray(t2d, bool), d2t=np.asarray(d2t, np.int32))
    os.replace(tmp, path)


def load_vocab_mapping(path: str) -> Tuple[np.ndarray, np.ndarray]:
    data = np.load(path)
    return data["t2d"].astype(bool), data["d2t"].astype(np.int32)
