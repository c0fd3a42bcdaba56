"""The port's chat templates, parsers and prompt builder against the JAX
package, on the CPU.

Every registered template (the same names as JAX's) and every parser
family (General, Thinking, GLM, Harmony) turns the same conversations into
the same ``input_ids`` and ``loss_mask`` as JAX's, exactly, with a
reversible character tokenizer (``tests/test_templates_parsers.py``'s
``CharTokenizer``), also with ``train_only_last_turn``; ``build_dataset``,
``tokenize_prompt_records`` (raw and pre-tokenised records),
``normalize_conversation``, ``prepare_prompt_tasks`` and the conversation
validator agree with JAX's."""

import numpy as np
import pytest

from specforge_tpu.data import conversation_validation as jax_validation
from specforge_tpu.data import parse as jax_parse
from specforge_tpu.data import prompt_builder as jax_prompts
from specforge_tpu.data import template as jax_template
from specforge_tpu_torch.data import conversation_validation as validation
from specforge_tpu_torch.data import parse, prompt_builder, template


class CharTokenizer:
    """Reversible codepoint tokenizer (``tests/test_templates_parsers.py``)."""

    bos_token_id = None

    def encode(self, text, add_special_tokens=False):
        return [ord(c) for c in text]

    def decode(self, ids):
        return "".join(chr(int(i)) for i in ids)


class BosCharTokenizer(CharTokenizer):
    bos_token_id = 1


CONVERSATIONS = {
    "two_turns": [
        {"role": "user", "content": "Q1"},
        {"role": "assistant", "content": "A1"},
        {"role": "user", "content": "Q2"},
        {"role": "assistant", "content": "A2"},
    ],
    "system_and_think": [
        {"role": "system", "content": "Be brief."},
        {"role": "user", "content": "solve it"},
        {"role": "assistant",
         "content": "<think>step one</think>the answer is four"},
        {"role": "user", "content": "and again?"},
        {"role": "assistant", "content": "let me think</think>Five."},
    ],
    "scaffold_and_analysis": [
        {"role": "user", "content": "Q"},
        {"role": "assistant", "content": "<think>\n\n</think>\n\nThe answer.",
         "analysis": "the user asks; answer"},
    ],
}
TOKENIZERS = {"chars": CharTokenizer(), "bos": BosCharTokenizer()}


def test_template_registry_matches_jax():
    assert template.template_names() == jax_template.template_names()
    for name in jax_template.template_names():
        assert template.get_template(name).__dict__ == (
            jax_template.get_template(name).__dict__), name


def assert_same_sample(mine, ref):
    np.testing.assert_array_equal(mine.input_ids, ref.input_ids)
    np.testing.assert_array_equal(mine.loss_mask, ref.loss_mask)
    assert mine.input_ids.dtype == ref.input_ids.dtype
    assert mine.loss_mask.dtype == ref.loss_mask.dtype


@pytest.mark.parametrize("last_turn", [False, True])
@pytest.mark.parametrize("name", jax_template.template_names())
def test_template_parsers_match_jax(name, last_turn):
    """The template's own parser on every conversation and tokenizer, at a
    length that keeps it whole and one that cuts it."""
    for tok_name, tok in TOKENIZERS.items():
        mine = parse.build_parser_for_template(
            tok, name, train_only_last_turn=last_turn)
        ref = jax_parse.build_parser_for_template(
            tok, name, train_only_last_turn=last_turn)
        assert type(mine).__name__ == type(ref).__name__
        for conv_name, conv in CONVERSATIONS.items():
            for max_length in (4096, 40):
                got = mine.parse(conv, max_length)
                want = ref.parse(conv, max_length)
                assert_same_sample(got, want)
                assert len(got.input_ids) <= max_length, (tok_name, conv_name)


@pytest.mark.parametrize("kind,kwargs", [
    ("general", {}), ("thinking", {}),
    ("thinking", {"supervise_thinking": True}), ("glm", {}),
    ("harmony", {}), ("general", {"train_only_last_turn": True})])
def test_parser_families_match_jax(kind, kwargs):
    """Each parser family on templates of other families too."""
    for name in ("qwen", "llama3", "glm-5.2", "raw"):
        mine = parse.build_parser(kind, CharTokenizer(), name, **kwargs)
        ref = jax_parse.build_parser(kind, CharTokenizer(), name, **kwargs)
        for conv in CONVERSATIONS.values():
            assert_same_sample(mine.parse(conv, 4096), ref.parse(conv, 4096))


def test_build_dataset_and_prompt_records_match_jax():
    records = [
        {"messages": CONVERSATIONS["two_turns"]},
        {"conversations": [{"from": "human", "value": "hi"},
                           {"from": "gpt", "value": "hello"}]},
        {"prompt": "a", "response": "b"},
        {"messages": [{"role": "user", "content": "nothing supervised"}]},
    ]
    for last_turn in (False, True):
        mine = parse.build_dataset(records, CharTokenizer(), "qwen", 160,
                                   train_only_last_turn=last_turn)
        ref = jax_parse.build_dataset(records, CharTokenizer(), "qwen", 160,
                                      train_only_last_turn=last_turn)
        assert len(mine) == len(ref) >= 2
        for got, want in zip(mine, ref):
            assert_same_sample(got, want)
    pre = {"input_ids": [1, 2, 3], "loss_mask": [0, 1, 1]}
    for last_turn in (False, True):
        mine = prompt_builder.tokenize_prompt_records(
            [pre, *records], CharTokenizer(), "llama3", 4096,
            train_only_last_turn=last_turn)
        ref = jax_prompts.tokenize_prompt_records(
            [pre, *records], CharTokenizer(), "llama3", 4096,
            train_only_last_turn=last_turn)
        assert mine == ref
        assert mine[0] is pre and len(mine) == 4
    with pytest.raises(ValueError, match="unrecognized"):
        parse.normalize_conversation({"bogus": 1})


def test_prompt_tasks_match_jax():
    records = [{"messages": [], "idx": i} for i in range(6)]
    for epoch, seed, shuffle in ((1, 7, True), (2, 7, True), (0, None, True),
                                 (1, 7, False)):
        mine = prompt_builder.prepare_prompt_tasks(
            records, epoch=epoch, prompt_seed=seed, shuffle=shuffle)
        ref = jax_prompts.prepare_prompt_tasks(
            records, epoch=epoch, prompt_seed=seed, shuffle=shuffle)
        assert [t.to_json() for t in mine] == [t.to_json() for t in ref]


@pytest.mark.parametrize("check_think", [False, True])
def test_conversation_validation_matches_jax(check_think):
    cases = [
        [], "x", [{"role": "user", "content": "q"}],
        CONVERSATIONS["two_turns"], CONVERSATIONS["system_and_think"],
        [{"role": "assistant", "content": "a"}],
        [{"role": "user", "content": "q"}, {"role": "system",
                                            "content": "s"}],
        [{"role": "user", "content": " "}],
        [{"role": "tool", "content": "t"}], ["not a dict"],
        [{"role": "system", "content": "s"}],
    ]
    for case in cases:
        assert validation.validate_conversation(case, check_think) == (
            jax_validation.validate_conversation(case, check_think))
