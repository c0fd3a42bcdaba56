"""Conversation-shape validation for the data-regeneration pipeline.

Counterpart of ``specforge_tpu/data/conversation_validation.py``.

Reference: scripts/conversation_validation.py — the contract both the
regeneration script and the reasoning-expansion script enforce before
touching a row:

- ``conversations`` is a non-empty list of ``{"role", "content"}`` dicts;
- content is a non-empty string;
- after an optional leading system turn, roles strictly alternate
  user → assistant → user → …;
- no turn may carry a ``<think>`` marker (reasoning text lives in
  ``reasoning_content``, never inline).
"""

from __future__ import annotations

from typing import Any, Optional

THINK_MARKERS = ("<think>", "</think>")


def has_think_marker(content: str) -> bool:
    lowered = content.lower()
    return any(marker in lowered for marker in THINK_MARKERS)


def validate_conversation(
    messages: Any, check_think: bool = False
) -> Optional[str]:
    """Return a human-readable reason the conversation is invalid, or None.

    ``check_think=False`` for regeneration INPUT rows: their old assistant
    turns (which may carry inline thinking) are replaced anyway, so only
    shape/role-order matters. Expansion of regenerated OUTPUT rows passes
    True."""
    if not isinstance(messages, list) or not messages:
        return "conversations must be a non-empty list"

    expected = "user"
    saw_user = False
    for i, message in enumerate(messages):
        if not isinstance(message, dict):
            return f"message {i} must be an object"
        role = message.get("role")
        content = message.get("content")
        if not isinstance(content, str) or not content.strip():
            return f"message {i} content must be a non-empty string"
        if role == "system":
            if saw_user:
                return f"message {i}: system turn after the first user turn"
            continue
        if role not in ("user", "assistant"):
            return f"message {i} has invalid role {role!r}"
        if role != expected:
            return (
                f"message {i}: expected role {expected!r}, got {role!r}"
            )
        if role == "user":
            saw_user = True
        expected = "assistant" if role == "user" else "user"
        if check_think and has_think_marker(content):
            return f"message {i} content contains a thinking marker"

    if not saw_user:
        return "conversation has no user turn"
    return None
