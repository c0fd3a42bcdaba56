"""Chat-template registry.

Counterpart of ``specforge_tpu/data/template.py``, with every template the
JAX package registers.

Declarative templates (system/user/assistant headers + terminators) for
rendering conversations and locating assistant spans for loss masks —
reference: specforge/data/template.py:7-29 and the per-model templates it
registers. Register new templates with :func:`register_template`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class ChatTemplate:
    name: str
    system_header: str
    user_header: str
    assistant_header: str
    end_token: str
    default_system_prompt: Optional[str] = None
    #: parser family this template renders for ("general" | "thinking" |
    #: "harmony" | "glm") — reference ChatTemplate.parser_type
    parser_type: str = "general"
    #: thinking templates: keep <think> spans supervisable context
    enable_thinking: bool = False
    #: literal strings whose tokens are rendered but never supervised even
    #: inside assistant bodies (reference ignore_token)
    ignore_tokens: tuple = ()

    @property
    def delimiter_style(self) -> bool:
        """end_token IS the next turn's header (glm-5.2, inkling): role
        headers delimit turns, so non-final turns render no terminator."""
        return bool(self.end_token) and self.end_token == self.user_header

    def render_system(self, content: str) -> str:
        end = "" if self.delimiter_style else self.end_token
        return f"{self.system_header}{content}{end}"

    def render_user(self, content: str) -> str:
        end = "" if self.delimiter_style else self.end_token
        return f"{self.user_header}{content}{end}"

    def render_assistant_header(self) -> str:
        return self.assistant_header

    def render_assistant_body(self, content: str) -> str:
        return f"{content}{self.end_token}"


_TEMPLATES: Dict[str, ChatTemplate] = {}


def register_template(template: ChatTemplate) -> ChatTemplate:
    _TEMPLATES[template.name] = template
    return template


def get_template(name: str) -> ChatTemplate:
    if name not in _TEMPLATES:
        raise KeyError(
            f"unknown chat template {name!r}; known: {sorted(_TEMPLATES)}"
        )
    return _TEMPLATES[name]


def template_names():
    return sorted(_TEMPLATES)


register_template(ChatTemplate(
    name="llama3",
    system_header="<|start_header_id|>system<|end_header_id|>\n\n",
    user_header="<|start_header_id|>user<|end_header_id|>\n\n",
    assistant_header="<|start_header_id|>assistant<|end_header_id|>\n\n",
    end_token="<|eot_id|>",
    default_system_prompt="You are a helpful assistant.",
))

# ChatML family: qwen / qwen2 / qwen3
for _name in ("qwen", "qwen2", "qwen3", "chatml"):
    register_template(ChatTemplate(
        name=_name,
        system_header="<|im_start|>system\n",
        user_header="<|im_start|>user\n",
        assistant_header="<|im_start|>assistant\n",
        end_token="<|im_end|>\n",
        default_system_prompt="You are a helpful assistant.",
    ))

register_template(ChatTemplate(
    name="deepseek",
    system_header="",
    user_header="<｜User｜>",
    assistant_header="<｜Assistant｜>",
    end_token="<｜end▁of▁sentence｜>",
))

register_template(ChatTemplate(
    name="raw",
    system_header="",
    user_header="",
    assistant_header="",
    end_token="",
))

register_template(ChatTemplate(
    name="glm",
    system_header="<|system|>\n",
    user_header="<|user|>\n",
    assistant_header="<|assistant|>\n",
    end_token="",
))

register_template(ChatTemplate(
    name="gemma",
    system_header="",
    user_header="<start_of_turn>user\n",
    assistant_header="<start_of_turn>model\n",
    end_token="<end_of_turn>\n",
    default_system_prompt="You are a helpful assistant.",
))

# ---------------------------------------------------------------------------
# breadth parity with the reference registry (specforge/data/template.py:92-):
# header/terminator strings are observable constants of the public models.
# ---------------------------------------------------------------------------

register_template(ChatTemplate(
    name="llama4",
    system_header="<|header_start|>system<|header_end|>\n\n",
    user_header="<|header_start|>user<|header_end|>",
    assistant_header="<|header_start|>assistant<|header_end|>\n\n",
    end_token="<|eot|>",
    default_system_prompt="You are a helpful assistant.",
))

register_template(ChatTemplate(
    name="lfm",
    system_header="<|im_start|>system\n",
    user_header="<|im_start|>user\n",
    assistant_header="<|im_start|>assistant\n",
    end_token="<|im_end|>\n",
))

register_template(ChatTemplate(
    name="phi3",
    system_header="<|system|>\n",
    user_header="<|user|>\n",
    assistant_header="<|assistant|>\n",
    end_token="<|end|>\n",
    default_system_prompt="You are a helpful assistant.",
))

register_template(ChatTemplate(
    name="phi4",
    system_header="<|im_start|>system<|im_sep|>",
    user_header="<|im_start|>user<|im_sep|>",
    assistant_header="<|im_start|>assistant<|im_sep|>",
    end_token="<|im_end|>",
    default_system_prompt="You are a helpful assistant.",
))

register_template(ChatTemplate(
    name="phi4-mini",
    system_header="<|system|>",
    user_header="<|user|>",
    assistant_header="<|assistant|>",
    end_token="<|end|>",
    default_system_prompt="You are a helpful assistant.",
))

register_template(ChatTemplate(
    name="gpt-oss-naive",
    system_header="<|start|>system<|message|>",
    user_header="<|start|>user<|message|>",
    assistant_header="<|start|>assistant<|channel|>analysis<|message|>",
    end_token="<|end|>",
))

register_template(ChatTemplate(
    name="gpt-oss",
    system_header="",
    user_header="",
    assistant_header="",
    end_token="",
    parser_type="harmony",
))

register_template(ChatTemplate(
    name="deepseek-r1-distill",
    system_header="",
    user_header="<｜User｜>",
    assistant_header="<｜Assistant｜>",
    end_token="",
))

register_template(ChatTemplate(
    name="qwen3-thinking",
    system_header="<|im_start|>system\n",
    user_header="<|im_start|>user\n",
    assistant_header="<|im_start|>assistant\n",
    end_token="<|im_end|>\n",
    default_system_prompt="You are a helpful assistant.",
    parser_type="thinking",
    enable_thinking=True,
))

register_template(ChatTemplate(
    name="qwen3-instruct",
    system_header="<|im_start|>system\n",
    user_header="<|im_start|>user\n",
    assistant_header="<|im_start|>assistant\n",
    end_token="<|im_end|>\n",
    default_system_prompt="You are a helpful assistant.",
    ignore_tokens=("<think>\n\n</think>\n\n",),
))

register_template(ChatTemplate(
    name="qwen3-next-thinking",
    system_header="<|im_start|>system\n",
    user_header="<|im_start|>user\n",
    assistant_header="<|im_start|>assistant\n<think>\n",
    end_token="<|im_end|>\n",
    default_system_prompt="You are a helpful assistant.",
    parser_type="thinking",
    enable_thinking=True,
))

register_template(ChatTemplate(
    name="qwen3.5",
    system_header="<|im_start|>system\n",
    user_header="<|im_start|>user\n",
    assistant_header="<|im_start|>assistant\n<think>\n",
    end_token="<|im_end|>\n",
    parser_type="thinking",
    enable_thinking=True,
))

register_template(ChatTemplate(
    name="kimi-k2-thinking",
    system_header="<|im_system|>system<|im_middle|>",
    user_header="<|im_start|>user\n",
    assistant_header="<|im_assistant|>assistant<|im_middle|>",
    end_token="<|im_end|>",
    default_system_prompt="You are a helpful assistant.",
    parser_type="thinking",
    enable_thinking=True,
))

register_template(ChatTemplate(
    name="kimi-k2-instruct",
    system_header="<|im_system|>system<|im_middle|>",
    user_header="<|im_start|>user\n",
    assistant_header="<|im_assistant|>assistant<|im_middle|>",
    end_token="<|im_end|>",
    default_system_prompt="You are a helpful assistant.",
))

register_template(ChatTemplate(
    name="kimi-k3-thinking",
    system_header='<|open|>message role="system"<|sep|>',
    user_header='<|open|>message role="user"<|sep|>',
    assistant_header=(
        '<|open|>message role="assistant"<|sep|><|open|>think<|sep|>'
    ),
    end_token="<|end_of_msg|>",
    parser_type="thinking",
    ignore_tokens=("<|end_of_msg|>",),
))

register_template(ChatTemplate(
    name="deepseek-v3",
    system_header="",
    user_header="<｜User｜>",
    assistant_header="<｜Assistant｜>",
    end_token="<｜end▁of▁sentence｜>",
    default_system_prompt="You are a helpful assistant.",
))

# DeepSeek-V2-Lite renders plain-text role headers (they must not reuse V3's
# special-token headers or the assistant loss anchor never matches).
register_template(ChatTemplate(
    name="deepseek-v2",
    system_header="",
    user_header="User: ",
    assistant_header="Assistant: ",
    end_token="<｜end▁of▁sentence｜>",
))

register_template(ChatTemplate(
    name="deepseek-v32",
    system_header="",
    user_header="<｜User｜>",
    assistant_header="<｜Assistant｜>",
    end_token="<｜end▁of▁sentence｜>",
    parser_type="thinking",
    enable_thinking=True,
))

register_template(ChatTemplate(
    name="ling-flash-2.0",
    system_header="<role>SYSTEM</role>",
    user_header="<role>HUMAN</role>",
    assistant_header="<role>ASSISTANT</role>",
    end_token="<|role_end|>",
    default_system_prompt="You are a helpful assistant.",
))

register_template(ChatTemplate(
    name="glm-5.2",
    system_header="<|system|>",
    user_header="<|user|>",
    assistant_header="<|assistant|><think>",
    end_token="<|user|>",
    parser_type="glm",
    ignore_tokens=("<|user|>",),
))

register_template(ChatTemplate(
    name="longcat",
    system_header=" SYSTEM:",
    user_header=" USER:",
    assistant_header=" ASSISTANT:",
    end_token="</longcat_s>",
    default_system_prompt="You are a helpful assistant.",
))

register_template(ChatTemplate(
    name="longcat_xml",
    system_header="<longcat_system>",
    user_header="<longcat_user>",
    assistant_header="<longcat_assistant>",
    end_token="</longcat_s>",
    default_system_prompt="You are a helpful assistant.",
))

register_template(ChatTemplate(
    name="inkling-thinking",
    system_header="<|message_system|>",
    user_header="<|message_user|>",
    assistant_header="<|message_model|>",
    end_token="<|message_user|>",
    parser_type="thinking",
    ignore_tokens=("<|message_user|>",),
))
