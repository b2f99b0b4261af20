"""The port's coding domain against the JAX package's: code extraction,
``outputs_match``, the stdin and functional scripts and the error taxonomy
of ``evaluate_coding_prediction`` under the same stub executors, the
datasets item for item (hub names raise, naming the missing files), and
rollouts of the ``coding`` preset under one scripted LLM, on the hermetic
path that refuses to run code and through a stub SandboxFusion server.
Mirrors the coding half of ``tests/test_coding_fn_domains.py``."""

import asyncio
import json
import re

import pytest

from pipelinerl_tpu.domains.coding import dataset as j_dataset
from pipelinerl_tpu.domains.coding import rollouts as j_rollouts
from pipelinerl_tpu.domains.coding import verifier as j_verifier
from pipelinerl_tpu_torch.domains.coding import dataset as t_dataset
from pipelinerl_tpu_torch.domains.coding import rollouts as t_rollouts
from pipelinerl_tpu_torch.domains.coding import verifier as t_verifier
from pipelinerl_tpu_torch.domains.math.rollouts import RewardTable
from tests.test_torch_domain_math import config_pair, outcome, scripted_rollouts
from tests.test_torch_domain_tir import sandbox_url  # noqa: F401 - a fixture
from tests.test_torch_domains import assert_same_rollout

PREDICTIONS = [
    "Here's my solution:\n```python\nprint('hi')\n```\ndone",
    "def f():\n    return 1",
    "just words",
    "```py\na=int(input());b=int(input());print(a+b)\n```",
    "```\nimport sys\nprint(sum(map(int, sys.stdin.read().split())))\n```",
    "```python\nx=1\n```\nthen\n```python\nprint(2)\n```",
    "class A: pass",
    "```python\nwhile True: pass\n```",
    "",
    None,
]
MATCHES = [("1.0000001\n2", "1.0 \n2\n"), ("  a  \n b ", "a\nb"), ("1\n2", "1\n3"), ("1", "1\n2"), ("0.0000001", "0"),
           ("3 4", "3.0 4.0000000001"), ("x y", "x z"), ("1e3", "1000"), (None, ""), ("2\n\n", "2"), ("1 2", "1")]


@pytest.mark.parametrize("prediction", PREDICTIONS)
def test_extract_code_equals_jax(prediction):
    assert t_verifier.extract_code(prediction) == j_verifier.extract_code(prediction)


@pytest.mark.parametrize("actual,expected", MATCHES)
def test_outputs_match_equals_jax(actual, expected):
    assert outcome(t_verifier.outputs_match, actual, expected) == outcome(j_verifier.outputs_match, actual, expected)


def test_scripts_equal_jax():
    code = "a=int(input());b=int(input());print(a+b)"
    assert t_verifier.build_stdin_script(code, "1\n2") == j_verifier.build_stdin_script(code, "1\n2")
    args = [[1, 2], "x", {"k": None}]
    assert t_verifier.build_functional_script(code, "f", args) == j_verifier.build_functional_script(code, "f", args)


class Executor:
    """A stub sandbox: sums the two integers of a stdin script, answers a
    functional script with 3, or returns a fixed failure."""

    def __init__(self, behavior):
        self.behavior = behavior
        self.scripts = []

    async def __call__(self, script: str) -> str:
        self.scripts.append(script)
        if self.behavior == "ok":
            m = re.search(r"StringIO\('(-?\d+)\\n(-?\d+)'\)", script)
            return str(int(m.group(1)) + int(m.group(2))) if m else "3"
        return {"timeout": "[execution timed out]", "crash": "x\n[stderr]\nTraceback (most recent call last): Error",
                "syntax": "  File x\nSyntaxError: bad", "transport": "[execution error: boom]",
                "stderr_warning": "7\n[stderr]\nwarning: slow", "json": "[1, 2]"}[self.behavior]


TESTS = [
    {"inputs": ["1\n2", "3\n4"], "outputs": ["3", "7"]},
    {"inputs": ["1\n2"], "outputs": ["999"]},
    {"fn_name": "add", "inputs": [[1, 2], [3, 4]], "outputs": [3, 7]},
    {"fn_name": "pair", "inputs": [[1]], "outputs": [[1, 2]]},
    [{"input": "5\n6", "expected_output": "11"}, {"input": ["2", "2"], "expected_output": "4"}],
    json.dumps({"inputs": ["1\n1"], "outputs": ["2"]}),
    "{not json",
    {"inputs": [], "outputs": []},
    {"inputs": [f"{i}\n{i}" for i in range(20)], "outputs": [str(2 * i) for i in range(20)]},
]


@pytest.mark.parametrize("behavior", ["ok", "timeout", "crash", "syntax", "transport", "stderr_warning", "json"])
@pytest.mark.parametrize("tests", range(len(TESTS)))
@pytest.mark.parametrize("prediction", [PREDICTIONS[3], PREDICTIONS[2]])
def test_evaluate_coding_prediction_equals_jax(prediction, tests, behavior):
    """The verdict, the counts, the error flags, the per-test details and
    the scripts sent, under each stub behaviour (``max_tests`` 16 cuts the
    20-case set)."""
    results = []
    for mod in (j_verifier, t_verifier):
        executor = Executor(behavior)
        v = asyncio.run(mod.evaluate_coding_prediction(prediction, TESTS[tests], executor))
        results.append((v.to_payload(), v.details, executor.scripts))
    assert results[1] == results[0]


def test_jax_test_cases_hold_on_the_port():
    assert t_verifier.extract_code(PREDICTIONS[0]) == "print('hi')" and t_verifier.extract_code("just words") == ""
    assert t_verifier.outputs_match("1.0000001\n2", "1.0 \n2\n") and not t_verifier.outputs_match("1", "1\n2")
    pred = "```python\na=int(input());b=int(input());print(a+b)\n```"
    v = asyncio.run(t_verifier.evaluate_coding_prediction(pred, TESTS[0], Executor("ok")))
    assert v.answer_status == "correct" and (v.passed, v.total) == (2, 2)
    v = asyncio.run(t_verifier.evaluate_coding_prediction(pred, TESTS[0], Executor("timeout")))
    assert v.timeout_error and v.answer_status == "unparsable"
    v = asyncio.run(t_verifier.evaluate_coding_prediction(pred, TESTS[0], Executor("crash")))
    assert v.runtime_error and v.answer_status == "wrong"
    v = asyncio.run(t_verifier.evaluate_coding_prediction("no code here", TESTS[7], Executor("ok")))
    assert v.answer_status == "no_answer" and v.empty_response


def test_datasets_equal_jax(tmp_path):
    assert t_dataset.load_datasets(["synthetic_coding"]) == j_dataset.load_datasets(["synthetic_coding"])
    assert len(t_dataset.load_datasets(["synthetic_coding"])) == 128
    rows = [{"question": "sum", "input_output": json.dumps({"inputs": ["1\n2"], "outputs": ["3"]})},
            {"task": "t", "tests": {"fn_name": "f", "inputs": [[1]], "outputs": [1]}},
            {"question_content": "q", "public_test_cases": [{"input": "1", "expected_output": "1"}]},
            {"question": "no tests"}, {"question": "bad", "input_output": "{oops"}]
    path = tmp_path / "lcb.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    assert t_dataset.load_datasets([str(path)]) == j_dataset.load_datasets([str(path)])
    for name in ("taco", "apps", "livecodebench"):
        with pytest.raises(ValueError, match="not in the repository"):
            t_dataset.load_datasets([name])
    with pytest.raises(ValueError, match="Unknown coding dataset"):
        t_dataset.load_datasets(["nope"])


CODE_REPLY = "```python\na=int(input());b=int(input());print(a+b)\n```"


@pytest.mark.parametrize("finish", ["stop", "length"])
@pytest.mark.parametrize("reply", [CODE_REPLY, "I cannot write code today", "print(1)"])
def test_coding_rollout_equals_jax_without_a_sandbox(reply, finish):
    """The hermetic path: code is never run, so a reply with code grades
    unparsable (the executor refuses it: a compile error) and one without
    grades no_answer; the reward is the table's, plus the overlong penalty
    when the buffer is set."""
    problem = t_dataset.load_datasets(["synthetic_coding"])[0]
    overrides = ["model_path=toy", "rewards.buffer_tokens=16"] if finish == "length" else ["model_path=toy"]
    cfgs = config_pair("coding", overrides)
    # a cut reply ends 2 tokens short of the budget, inside the 16-token buffer
    j, t = scripted_rollouts(j_rollouts.generate_coding_rollout, t_rollouts.generate_coding_rollout, cfgs, problem,
                             [reply], finish=finish, max_tokens=len(reply) + 2)
    assert_same_rollout(j, t)
    metrics = t[0].metrics
    table = RewardTable.from_config(cfgs[1])
    status = "unparsable" if t_verifier.extract_code(reply) else "no_answer"
    base = getattr(table, f"{'unparsable' if status == 'unparsable' else 'no_answer'}_"
                          f"{'finished' if finish == 'stop' else 'not_finished'}")
    assert metrics.reward == pytest.approx(base + metrics.penalty)
    assert metrics.compile_error == (status == "unparsable") and metrics.no_answer == (status == "no_answer")
    assert (metrics.penalty == 0.0) == (finish == "stop")


@pytest.mark.parametrize("reply", [CODE_REPLY, "```python\nprint(99)\n```"])
def test_coding_rollout_through_the_sandbox_equals_jax(reply, sandbox_url):  # noqa: F811
    """With ``sandbox_url`` set, the tests run on the stub (which sums the
    two stdin integers) in both packages: the first reply passes every
    test; the second, whose code the stub also sums, too."""
    problem = t_dataset.load_datasets(["synthetic_coding"])[3]
    cfgs = config_pair("coding", ["model_path=toy", f"sandbox_url={sandbox_url}"])
    j, t = scripted_rollouts(j_rollouts.generate_coding_rollout, t_rollouts.generate_coding_rollout, cfgs, problem,
                             [reply])
    assert_same_rollout(j, t)
    assert t[0].metrics.success and t[0].metrics.passed == t[0].metrics.total == 2
