"""VLM (multimodal) data helpers: mrope 3D position ids.

Counterpart of ``specforge_tpu/data/vlm.py``. Qwen2-VL-style ``get_rope_index`` semantics: text tokens advance all three
rope axes (temporal/height/width) together; each vision span of grid
``(t, h, w)`` lays its tokens out with per-axis grid indices offset from the
running position, and text after the span resumes at
``base + max(t, h, w)``. The collator pads the resulting [3, S] on the
sequence axis; the rope math itself is ``ops/rope.py``
``apply_multimodal_rope``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class VisionSpan:
    """A contiguous run of vision tokens inside the token sequence."""

    start: int      # first token index of the span
    t: int          # temporal grid (1 for images)
    h: int          # height grid (post-merge patches)
    w: int          # width grid

    @property
    def length(self) -> int:
        return self.t * self.h * self.w


def mrope_position_ids(
    seq_len: int, spans: Sequence[VisionSpan] = ()
) -> np.ndarray:
    """[3, seq_len] int32 position ids for a mixed text/vision sequence.

    With no spans this degenerates to ``arange`` on all three axes (plain
    rope — mrope is backward compatible with text-only sequences).
    """
    out = np.zeros((3, seq_len), np.int32)
    spans = sorted(spans, key=lambda s: s.start)
    pos = 0        # running rope position (next text token's index)
    cursor = 0     # token cursor in the sequence
    for span in spans:
        if span.start < cursor:
            raise ValueError(f"overlapping vision span at {span.start}")
        if span.start + span.length > seq_len:
            raise ValueError(
                f"vision span [{span.start}, {span.start + span.length}) "
                f"exceeds seq_len {seq_len}"
            )
        # text before the span
        n_text = span.start - cursor
        text_pos = np.arange(pos, pos + n_text, dtype=np.int32)
        out[:, cursor:span.start] = text_pos[None, :]
        pos += n_text
        cursor = span.start
        # the span: grid indices offset by the current position
        t_idx = np.repeat(np.arange(span.t, dtype=np.int32),
                          span.h * span.w)
        h_idx = np.tile(
            np.repeat(np.arange(span.h, dtype=np.int32), span.w), span.t
        )
        w_idx = np.tile(np.arange(span.w, dtype=np.int32),
                        span.t * span.h)
        end = cursor + span.length
        out[0, cursor:end] = pos + t_idx
        out[1, cursor:end] = pos + h_idx
        out[2, cursor:end] = pos + w_idx
        pos += max(span.t, span.h, span.w)
        cursor = end
    # trailing text
    n_text = seq_len - cursor
    text_pos = np.arange(pos, pos + n_text, dtype=np.int32)
    out[:, cursor:] = text_pos[None, :]
    return out


def spans_from_token_ids(
    input_ids: Sequence[int],
    image_token_id: int,
    grids: Sequence[Tuple[int, int, int]],
) -> List[VisionSpan]:
    """Locate contiguous ``image_token_id`` runs and pair them with their
    ``(t, h, w)`` grids (one grid per image, in order)."""
    ids = np.asarray(input_ids)
    spans: List[VisionSpan] = []
    grid_iter = iter(grids)
    i = 0
    while i < len(ids):
        if ids[i] == image_token_id:
            start = i
            while i < len(ids) and ids[i] == image_token_id:
                i += 1
            try:
                t, h, w = next(grid_iter)
            except StopIteration:
                raise ValueError(
                    "more image-token runs than grids provided"
                ) from None
            if t * h * w != i - start:
                raise ValueError(
                    f"image run length {i - start} != grid {t}x{h}x{w}"
                )
            spans.append(VisionSpan(start=start, t=t, h=h, w=w))
        else:
            i += 1
    return spans
