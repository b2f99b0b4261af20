"""The port's fn_calling domain against the JAX package's:
``parse_tool_calls`` (now beside ``StreamingToolParser`` in
``inference/tool_parser.py``), ``parse_call`` and ``ast_match_score`` on the
JAX tests' cases and more, the datasets item for item, and rollouts under
one scripted LLM on the toy and the fixture tokenizers, the tools rendered by
a chat template that has a tools block."""

import json
import shutil
from pathlib import Path

import pytest

from pipelinerl_tpu.domains.fn_calling import dataset as j_dataset
from pipelinerl_tpu.domains.fn_calling import rollouts as j_rollouts
from pipelinerl_tpu.domains.fn_calling import verifier as j_verifier
from pipelinerl_tpu.domains.tir import tool_parser as j_tool_parser
from pipelinerl_tpu_torch.domains.fn_calling import dataset as t_dataset
from pipelinerl_tpu_torch.domains.fn_calling import rollouts as t_rollouts
from pipelinerl_tpu_torch.domains.fn_calling import verifier as t_verifier
from pipelinerl_tpu_torch.inference import tool_parser as t_tool_parser
from tests.test_torch_domain_math import FIXTURE, config_pair, outcome, scripted_rollouts, tokenizer_pair
from tests.test_torch_domains import assert_same_rollout

TOOLS_TEMPLATE = FIXTURE.parent / "chat_template_tools.jinja"
CALL = '<tool_call>{{"name": "get_weather", "arguments": {}}}</tool_call>'
TEXTS = [
    CALL.format('{"city": "Paris"}'),
    CALL.format('{"city": "paris", "unit": "celsius"}') + " and " + CALL.format('{"city": "Rome"}'),
    '<tool_calls>[{"name": "f", "arguments": {"x": 2, "y": 0.5000001}}, {"function": {"name": "g"}}]</tool_calls>',
    "<tool_call>not json</tool_call> [BEGIN FINAL RESPONSE]done[END FINAL RESPONSE]",
    '<tool_call>{"function": {"name": "h", "arguments": "{\\"a\\": 1}"}}</tool_call> tail',
    "I'll call get_weather(city='Oslo', unit='celsius')",
    "[get_weather(city='Lima'), print(x=1), other(b=[1, 2])]",
    "bad(syntax=) and f(x=1, **k)",
    '<tool_call>{"name": "get_weather", "arguments": "[1]"}</tool_call>',
    "no calls at all",
    "",
]
GOLDS = [
    [{"name": "get_weather", "arguments": {"city": "Paris", "unit": []}}],
    [{"name": "f", "arguments": {"x": [1, 2], "y": 0.5}}],
    {"get_weather": {"city": ["Oslo", "Lima"], "unit": ["celsius", "fahrenheit"]}},
    [{"name": "get_weather", "arguments": {"city": "Rome"}}, {"name": "get_weather", "arguments": {"city": "Paris"}}],
    [],
]


def _calls(parse, text):
    calls, content = parse(text)
    return [c.function.__dict__ for c in calls], content


@pytest.mark.parametrize("text", TEXTS)
def test_parse_tool_calls_and_parse_call_equal_jax(text):
    assert _calls(t_tool_parser.parse_tool_calls, text) == _calls(j_tool_parser.parse_tool_calls, text)
    assert t_verifier.parse_call(text) == j_verifier.parse_call(text)


@pytest.mark.parametrize("gold", GOLDS)
def test_ast_match_score_equals_jax(gold):
    for text in TEXTS:
        assert outcome(t_verifier.ast_match_score, text, gold) == outcome(j_verifier.ast_match_score, text, gold)


def test_jax_test_cases_hold_on_the_port():
    gold = GOLDS[0]
    assert t_verifier.ast_match_score(CALL.format('{"city": "paris"}'), gold) == 1.0
    assert t_verifier.ast_match_score(CALL.format('{"city": "Rome"}'), gold) == 0.0
    two = CALL.format('{"city": "Paris"}') + '<tool_call>{"name": "bogus", "arguments": {}}</tool_call>'
    assert t_verifier.ast_match_score(two, gold) == pytest.approx(0.5)
    assert t_verifier.ast_match_score(TEXTS[2], GOLDS[1]) == 0.5  # f matches, g dilutes


def test_datasets_equal_jax(tmp_path):
    assert t_dataset.load_datasets(["synthetic_fn_calling"]) == j_dataset.load_datasets(["synthetic_fn_calling"])
    rows = [{"question": [[{"role": "user", "content": "weather?"}]], "function": {"name": "w"},
             "answer": '[{"w": {}}]'},
            {"task": "t", "tools": [], "gold_calls": [{"name": "x"}]}, {"question": "q", "answer": "not json"}]
    path = tmp_path / "bfcl.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    assert t_dataset.load_datasets([str(path)]) == j_dataset.load_datasets([str(path)])
    with pytest.raises(ValueError):
        t_dataset.load_datasets(["nope"])


@pytest.fixture(scope="module")
def tools_tokenizer_dir(tmp_path_factory):
    """A copy of the fixture tokenizer whose chat template has Qwen2.5's
    tools block (the committed fixture's ChatML template drops tools)."""
    directory = tmp_path_factory.mktemp("tools_tokenizer")
    for f in FIXTURE.iterdir():
        shutil.copy(f, directory / f.name)
    shutil.copy(TOOLS_TEMPLATE, directory / "chat_template.jinja")
    return directory


@pytest.mark.parametrize("kind", ["toy", "fixture", "tools"])
@pytest.mark.parametrize("reply", [CALL.format('{"city": "Paris"}'), CALL.format('{"city": "Oslo"}'),
                                   "get_weather(city='Paris')", "it is sunny"])
def test_fn_calling_rollout_equals_jax(kind, reply, tools_tokenizer_dir):
    problem = t_dataset.load_datasets(["synthetic_fn_calling"])[0]
    problem["task"] = "What's the weather in Paris right now?"
    problem["gold_calls"] = [{"name": "get_weather", "arguments": {"city": "Paris", "unit": []}}]
    kind = tools_tokenizer_dir if kind == "tools" else kind
    j, t = scripted_rollouts(j_rollouts.generate_fn_calling_rollout, t_rollouts.generate_fn_calling_rollout,
                             config_pair("fn_calling", ["model_path=toy"]), problem, [reply], kind=kind)
    assert_same_rollout(j, t)
    assert t[0].metrics.reward == (1.0 if "Paris" in reply else 0.0)
    if isinstance(kind, Path):  # the tools reached the prompt through the template
        prompt = tokenizer_pair(kind)[1].decode(t[1][0])
        assert "<tools>" in prompt and '"name": "get_weather"' in prompt and '"enum": ["celsius", "fahrenheit"]' in prompt
