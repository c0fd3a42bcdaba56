"""Conversation parsing → token ids + assistant-span loss masks.

Counterpart of ``specforge_tpu/data/parse.py``: the General, Thinking, GLM
and Harmony parsers and ``build_dataset``. A tokenizer is any object with
``encode(text, add_special_tokens=False)`` and ``bos_token_id``; the port
imports no tokenizer package.

The parser renders each turn with the chat template and tokenizes piecewise
(``add_special_tokens=False`` per piece), so assistant-answer token spans are
known exactly — the loss mask supervises assistant bodies (including the end
token) and nothing else. Reference behavior:
specforge/data/parse.py:15-510 (GeneralParser; Harmony/Thinking/GLM parsers add
channel/thinking-span handling on the same skeleton).

Conversation format: ``[{"role": "system"|"user"|"assistant", "content": str}]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from specforge_tpu_torch.data.template import ChatTemplate, get_template


@dataclass
class ParsedSample:
    input_ids: np.ndarray  # [S] int64
    loss_mask: np.ndarray  # [S] int64


class GeneralParser:
    def __init__(self, tokenizer, template: ChatTemplate, *,
                 train_only_last_turn: bool = False):
        self.tokenizer = tokenizer
        self.template = template
        #: supervise only the final assistant turn (reference
        #: data/parse.py:283 + schema.py:143 train_only_last_turn)
        self.train_only_last_turn = train_only_last_turn

    def _assemble(self, pieces, max_length: int) -> ParsedSample:
        """(ids, supervised[, assistant_turn_idx]) pieces → ParsedSample.

        With ``train_only_last_turn``, supervision is kept only for pieces
        tagged with the LAST assistant turn's index."""
        if self.train_only_last_turn:
            last = max(
                (p[2] for p in pieces if len(p) > 2 and p[2] is not None),
                default=None,
            )
            pieces = [
                (
                    p[0],
                    p[1]
                    if len(p) > 2 and p[2] is not None and p[2] == last
                    else 0,
                )
                for p in pieces
            ]
        ids: List[int] = []
        mask: List[int] = []
        for piece in pieces:
            ids.extend(piece[0])
            mask.extend([piece[1]] * len(piece[0]))
        return ParsedSample(
            input_ids=np.asarray(ids[:max_length], np.int64),
            loss_mask=np.asarray(mask[:max_length], np.int64),
        )

    def _encode(self, text: str) -> List[int]:
        if not text:
            return []
        return self.tokenizer.encode(text, add_special_tokens=False)

    @staticmethod
    def _next_role(conversation, turn):
        turns = list(conversation)
        idx = next(
            (i for i, t in enumerate(turns) if t is turn), len(turns) - 1
        )
        return turns[idx + 1].get("role") if idx + 1 < len(turns) else None

    def _assistant_body_pieces(
        self, content: str, next_role: Optional[str]
    ) -> List[Tuple[List[int], int]]:
        """Assistant body → (ids, supervised) pieces.

        Honors two reference template behaviors: ``ignore_tokens`` (rendered
        but never supervised, e.g. qwen3-instruct's empty think scaffold or
        kimi-k3's stop-trimmed end token) and delimiter-style terminators
        (end_token == user_header, e.g. glm-5.2/inkling: the terminator IS
        the next turn's header, so mid-conversation it is not re-rendered)."""
        tmpl = self.template
        end = tmpl.end_token
        drop_end = bool(end) and end == tmpl.user_header and (
            next_role is not None
        )
        body = content if drop_end else content + end
        prefix: List[str] = []
        suffix: List[str] = []
        changed = True
        while changed:
            changed = False
            for ig in tmpl.ignore_tokens:
                if ig and body.startswith(ig):
                    prefix.append(ig)
                    body = body[len(ig):]
                    changed = True
                if ig and body and body.endswith(ig):
                    suffix.insert(0, ig)
                    body = body[: -len(ig)]
                    changed = True
        out: List[Tuple[List[int], int]] = []
        for text in prefix:
            out.append((self._encode(text), 0))
        if body:
            out.append((self._encode(body), 1))
        for text in suffix:
            out.append((self._encode(text), 0))
        return out

    def parse(
        self,
        conversation: Sequence[Dict[str, Any]],
        max_length: int,
        *,
        add_bos: bool = True,
    ) -> ParsedSample:
        pieces: List[Tuple[List[int], int]] = []  # (ids, supervised)
        bos = (
            [self.tokenizer.bos_token_id]
            if add_bos and self.tokenizer.bos_token_id is not None
            else []
        )
        if bos:
            pieces.append((bos, 0))

        has_system = any(t.get("role") == "system" for t in conversation)
        if not has_system and self.template.default_system_prompt:
            pieces.append((
                self._encode(
                    self.template.render_system(
                        self.template.default_system_prompt
                    )
                ),
                0,
            ))
        a_idx = -1
        for turn in conversation:
            role = turn.get("role")
            content = str(turn.get("content", ""))
            if role == "system":
                pieces.append((
                    self._encode(self.template.render_system(content)), 0
                ))
            elif role in ("user", "human"):
                pieces.append((
                    self._encode(self.template.render_user(content)), 0
                ))
            elif role in ("assistant", "gpt"):
                a_idx += 1
                pieces.append((
                    self._encode(self.template.render_assistant_header()), 0
                ))
                next_role = self._next_role(conversation, turn)
                pieces.extend(
                    (ids_, sup, a_idx)
                    for ids_, sup in self._assistant_body_pieces(
                        content, next_role
                    )
                )
            else:
                raise ValueError(f"unknown conversation role {role!r}")

        return self._assemble(pieces, max_length)


def normalize_conversation(record: Dict[str, Any]) -> List[Dict[str, str]]:
    """Accept common dataset shapes: ``messages``, ``conversations``
    (sharegpt ``from``/``value``), or prompt/response pairs."""
    if "messages" in record:
        return [
            {"role": m["role"], "content": m["content"]}
            for m in record["messages"]
        ]
    if "conversations" in record:
        out = []
        role_map = {"human": "user", "gpt": "assistant", "system": "system",
                    "user": "user", "assistant": "assistant"}
        for m in record["conversations"]:
            role = role_map.get(m.get("from") or m.get("role"))
            if role is None:
                continue
            out.append(
                {"role": role, "content": m.get("value") or m.get("content", "")}
            )
        return out
    if "prompt" in record and "response" in record:
        return [
            {"role": "user", "content": record["prompt"]},
            {"role": "assistant", "content": record["response"]},
        ]
    raise ValueError(
        f"unrecognized conversation record keys: {sorted(record)}"
    )


def build_dataset(
    records,
    tokenizer,
    template_name: str,
    max_length: int,
    *,
    train_only_last_turn: bool = False,
) -> List[ParsedSample]:
    """Tokenize a list of conversation records (reference
    ``build_eagle3_dataset``, data/preprocessing.py:109-394)."""
    parser = build_parser_for_template(
        tokenizer, template_name, train_only_last_turn=train_only_last_turn
    )
    out: List[ParsedSample] = []
    for record in records:
        conversation = normalize_conversation(record)
        sample = parser.parse(conversation, max_length)
        if sample.loss_mask.sum() == 0 or len(sample.input_ids) < 2:
            continue  # nothing supervised: skip (reference drops these too)
        out.append(sample)
    return out


class ThinkingParser(GeneralParser):
    """Assistant turns may carry ``<think>...</think>`` spans; the thinking
    body is included in context but (optionally) excluded from the loss —
    reference ThinkingParser behavior (data/parse.py Thinking variant)."""

    def __init__(self, tokenizer, template, *, supervise_thinking=False,
                 think_open="<think>", think_close="</think>",
                 train_only_last_turn=False):
        super().__init__(
            tokenizer, template, train_only_last_turn=train_only_last_turn
        )
        self.supervise_thinking = supervise_thinking
        self.think_open = think_open
        self.think_close = think_close

    def parse(self, conversation, max_length, *, add_bos=True):
        pieces: List[Tuple[List[int], int]] = []
        bos = (
            [self.tokenizer.bos_token_id]
            if add_bos and self.tokenizer.bos_token_id is not None
            else []
        )
        if bos:
            pieces.append((bos, 0))
        has_system = any(t.get("role") == "system" for t in conversation)
        if not has_system and self.template.default_system_prompt:
            pieces.append((
                self._encode(self.template.render_system(
                    self.template.default_system_prompt
                )), 0,
            ))
        a_idx = -1
        for turn in conversation:
            role = turn.get("role")
            content = str(turn.get("content", ""))
            if role == "system":
                pieces.append((
                    self._encode(self.template.render_system(content)), 0
                ))
            elif role in ("user", "human"):
                pieces.append((
                    self._encode(self.template.render_user(content)), 0
                ))
            elif role in ("assistant", "gpt"):
                a_idx += 1
                pieces.append((
                    self._encode(self.template.render_assistant_header()), 0
                ))
                remaining = content
                while self.think_open in remaining:
                    before, rest = remaining.split(self.think_open, 1)
                    if before:
                        pieces.append((self._encode(before), 1, a_idx))
                    if self.think_close in rest:
                        think, remaining = rest.split(self.think_close, 1)
                    else:
                        think, remaining = rest, ""
                    think_text = (
                        f"{self.think_open}{think}{self.think_close}"
                    )
                    pieces.append((
                        self._encode(think_text),
                        1 if self.supervise_thinking else 0,
                        a_idx,
                    ))
                next_role = self._next_role(conversation, turn)
                pieces.extend(
                    (ids_, sup, a_idx)
                    for ids_, sup in self._assistant_body_pieces(
                        remaining, next_role
                    )
                )
            else:
                raise ValueError(f"unknown conversation role {role!r}")
        return self._assemble(pieces, max_length)


class GLMParser(ThinkingParser):
    """GLM-5.2 hybrid-thinking rendering (reference GLMParser,
    data/parse.py:510: forces ``enable_thinking=False``).

    The assistant header carries the opening ``<think>`` scaffold; with
    thinking disabled the span closes immediately, and any raw reasoning text
    terminated by ``</think>`` at the head of the content stays unsupervised
    context. The ``<|user|>`` terminator is delimiter-style + ignored (never
    supervised)."""

    def __init__(self, tokenizer, template, **kwargs):
        kwargs.setdefault("supervise_thinking", False)
        think_open = kwargs.get("think_open", "<think>")
        if template.assistant_header.endswith(think_open):
            # the scaffold opener moves into the (un)supervised think span so
            # the ThinkingParser renders it exactly once
            import dataclasses

            template = dataclasses.replace(
                template,
                assistant_header=template.assistant_header[
                    : -len(think_open)
                ],
            )
        super().__init__(tokenizer, template, **kwargs)

    def parse(self, conversation, max_length, *, add_bos=True):
        rewritten = []
        for turn in conversation:
            if turn.get("role") in ("assistant", "gpt"):
                content = str(turn.get("content", ""))
                if self.think_open not in content:
                    if self.think_close in content:
                        # raw reasoning head (opener lives in the header)
                        reasoning, rest = content.split(self.think_close, 1)
                        content = (
                            f"{self.think_open}{reasoning}"
                            f"{self.think_close}{rest}"
                        )
                    else:
                        # close the header's scaffold immediately
                        content = f"{self.think_open}{self.think_close}{content}"
                turn = {**turn, "content": content}
            rewritten.append(turn)
        return super().parse(rewritten, max_length, add_bos=add_bos)


class HarmonyParser(GeneralParser):
    """gpt-oss Harmony channel format: assistant messages route through
    ``analysis`` (reasoning, unsupervised) and ``final`` (supervised)
    channels — simplified single-channel rendering of the reference
    HarmonyParser."""

    def parse(self, conversation, max_length, *, add_bos=True):
        pieces: List[Tuple[List[int], int]] = []
        if add_bos and self.tokenizer.bos_token_id is not None:
            pieces.append(([self.tokenizer.bos_token_id], 0))
        a_idx = -1
        for turn in conversation:
            role = turn.get("role")
            content = str(turn.get("content", ""))
            analysis = turn.get("analysis")
            if role == "assistant":
                a_idx += 1
                if analysis:
                    pieces.append((self._encode(
                        f"<|start|>assistant<|channel|>analysis"
                        f"<|message|>{analysis}<|end|>"
                    ), 0))
                pieces.append((self._encode(
                    "<|start|>assistant<|channel|>final<|message|>"
                ), 0))
                pieces.append(
                    (self._encode(f"{content}<|return|>"), 1, a_idx)
                )
            else:
                pieces.append((self._encode(
                    f"<|start|>{role}<|message|>{content}<|end|>"
                ), 0))
        return self._assemble(pieces, max_length)


PARSERS = {
    "general": GeneralParser,
    "thinking": ThinkingParser,
    "harmony": HarmonyParser,
    "glm": GLMParser,
}


def build_parser(kind: str, tokenizer, template_name: str, **kwargs):
    from specforge_tpu_torch.data.template import get_template

    cls = PARSERS[kind]
    return cls(tokenizer, get_template(template_name), **kwargs)


def build_parser_for_template(tokenizer, template_name: str, **kwargs):
    """Resolve the parser family from the template's ``parser_type`` — the
    reference's template→parser dispatch (data/parse.py:15-510)."""
    from specforge_tpu_torch.data.template import get_template

    template = get_template(template_name)
    cls = PARSERS[template.parser_type]
    if template.parser_type == "thinking":
        kwargs.setdefault("supervise_thinking", template.enable_thinking)
    return cls(tokenizer, template, **kwargs)
