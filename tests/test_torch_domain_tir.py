"""The port's TIR domain against the JAX package's: the tool parser (Hermes,
Apriel, final-response sections, and the streaming parser fed the same
texts in random pieces), the code-safety blocklist and the hermetic
expression evaluator, ``compute_shaping`` over a grid of configs, the tool
definitions, ``SandboxFusionClient`` beside JAX's aiohttp client against
one stdlib stub server, and rollouts of the ``tir`` preset under one
scripted LLM (same rewards, ``model_dump`` metrics and training-text
tokens), with the stub as the sandbox too. Mirrors
``tests/test_tir_domain.py``."""

import asyncio
import copy
import itertools
import json
import random
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from chip_smoke import tir_rewards
from pipelinerl_tpu.config import Config as JConfig
from pipelinerl_tpu.domains.tir import rollouts as j_rollouts
from pipelinerl_tpu.domains.tir import sandbox as j_sandbox
from pipelinerl_tpu.domains.tir import tool_parser as j_parser
from pipelinerl_tpu_torch.config import Config
from pipelinerl_tpu_torch.domains.math.rollouts import RewardTable
from pipelinerl_tpu_torch.domains.tir import rollouts as t_rollouts
from pipelinerl_tpu_torch.domains.tir import sandbox as t_sandbox
from pipelinerl_tpu_torch.domains.tir import tool_parser as t_parser
from pipelinerl_tpu_torch.train.advantages import training_text_to_sample
from tests.test_torch_domain_fn_calling import tools_tokenizer_dir  # noqa: F401 - a fixture
from tests.test_torch_domain_math import config_pair, scripted_rollouts, tokenizer_pair
from tests.test_torch_domains import assert_same_rollout

PY = '<tool_call>{{"name": "run_python_code", "arguments": {{"code": {}}}}}</tool_call>'
ANSWER = '<tool_call>{{"name": "MathAnswer", "arguments": {{"answer": {}}}}}</tool_call>'
TEXTS = [
    'thinking... <tool_call>{"name": "run_python_code", "arguments": {"code": "print(2+2)"}}</tool_call>',
    '<tool_calls>[{"name": "MathAnswer", "arguments": {"answer": "42"}}]</tool_calls>',
    "<tool_call>{not json}</tool_call> rest",
    "junk [BEGIN FINAL RESPONSE]the answer[END FINAL RESPONSE]",
    "[BEGIN FINAL RESPONSE] open-ended",
    PY.format('"print(6*7)"') + " then " + ANSWER.format('"42"'),
    '<tool_call>{"function": {"name": "run_python_code", "arguments": "{\\"code\\": \\"1+1\\"}"}}</tool_call>',
    '<tool_calls>[{"name": "a"}, 3, {"arguments": {}}]</tool_calls><tool_call>[1, 2]</tool_call>',
    "<tool_call>unclosed",
    "<tool_c",
    "",
]


def _calls(parse, text):
    calls, content = parse(text)
    return [(c.function.name, c.function.arguments, c.type) for c in calls], content


@pytest.mark.parametrize("text", TEXTS)
def test_parse_tool_calls_equals_jax(text):
    assert _calls(t_parser.parse_tool_calls, text) == _calls(j_parser.parse_tool_calls, text)


@pytest.mark.parametrize("seed", range(4))
def test_streaming_parser_equals_jax(seed):
    """All texts in one stream, cut into the same random pieces for both
    parsers: the released content and the calls of every delta, and the
    flush."""
    rng = random.Random(seed)
    text = "".join(TEXTS[:-3]) + "tail <tool_call"
    cuts = sorted(rng.sample(range(1, len(text)), 40))
    pieces = [text[a:b] for a, b in zip([0, *cuts], [*cuts, len(text)])]
    parsers = (j_parser.StreamingToolParser(), t_parser.StreamingToolParser())
    for piece in pieces:
        j_out, t_out = (p.feed(piece) for p in parsers)
        assert t_out[0] == j_out[0]
        assert [(c.function.name, c.function.arguments) for c in t_out[1]] == \
               [(c.function.name, c.function.arguments) for c in j_out[1]]
    assert parsers[1].flush() == parsers[0].flush()


CODES = ["import subprocess; subprocess.run(['ls'])", "os.system('rm -rf /')", "print(1+1)", "sys.exit(0)",
         "os._exit(1)", "os.execv('x', [])", "os.spawnl(0, 'x')", "shutil.rmtree('/')", "os.unlink('f')",
         "subprocess_like = 1", "print(2+2*3)", "import os\nos.system('x')", "print(1/3)", "x = 5\nprint(x)",
         "print((2**10) - 24)", "7*6", "print(3.5*2)", "print(1/0)", "  \n", "print(abs(-3))"]


@pytest.mark.parametrize("code", CODES)
def test_safety_and_expression_executor_equal_jax(code):
    assert t_sandbox.check_code_safety(code) == j_sandbox.check_code_safety(code)
    assert asyncio.run(t_sandbox.safe_expression_executor(code)) == \
           asyncio.run(j_sandbox.safe_expression_executor(code))


def test_jax_test_cases_hold_on_the_port():
    calls, content = t_parser.parse_tool_calls(TEXTS[0])
    assert calls[0].function.name == "run_python_code" and json.loads(calls[0].function.arguments) == \
        {"code": "print(2+2)"} and content == "thinking..."
    assert t_parser.parse_tool_calls("junk [BEGIN FINAL RESPONSE]the answer[END FINAL RESPONSE]")[1] == "the answer"
    assert asyncio.run(t_sandbox.safe_expression_executor("print(2+2*3)")) == "8"
    assert asyncio.run(t_sandbox.safe_expression_executor("import os\nos.system('x')")).startswith("Blocked")
    assert {t["function"]["name"] for t in t_rollouts.build_tool_definitions()} == {"run_python_code", "MathAnswer"}
    assert t_rollouts.build_tool_definitions() == j_rollouts.build_tool_definitions()


SHAPING = [
    {"python_tool_shaping": {"bonus_on_correct_with_python": 0.1, "penalty_on_incorrect_without_python": 0.1,
                             "max_abs": 0.2}},
    {"python_tool_shaping": {"bonus_on_correct_with_python": 0.5, "penalty_on_incorrect_without_python": 0.4,
                             "max_abs": 0.25}},
    {"length_shaping": {"target_output_tokens": 100, "slope": 0.01, "max_penalty": 0.5,
                        "bonus_on_short_correct": 0.2}},
    {"length_shaping": {"target_ratio": 0.5, "min_target_tokens": 80, "max_target_tokens": 300, "slope": 0.002,
                        "max_penalty": 0.3, "bonus_on_short_correct": 0.1},
     "python_tool_shaping": {"bonus_on_correct_with_python": 0.1}},
    {"length_shaping": {"target_ratio": 0.5, "slope": 0.0, "max_penalty": 0.0, "bonus_on_short_correct": 0.0}},
    {},
]


@pytest.mark.parametrize("index", range(len(SHAPING)))
def test_compute_shaping_equals_jax(index):
    """Every (answer status, python calls, mean turn length, budget) of a
    grid, under each config: the JAX tests' two, clipping at ``max_abs``,
    a target from ``target_ratio`` clamped both ways, the preset's."""
    grid = itertools.product(["correct", "wrong", "unparsable", "no_answer"], [0, 1, 3], [20.0, 100.0, 150.0, 900.0],
                             [64, 1000, 16000])
    for status, calls, avg, budget in grid:
        t = t_rollouts.compute_shaping(Config(SHAPING[index]), status, calls, avg, budget)
        assert t == j_rollouts.compute_shaping(JConfig(SHAPING[index]), status, calls, avg, budget)


# the scripted replies of a TIR rollout: (replies, expected status)
ROLLOUTS = {
    "python_then_answer": ([PY.format('"print(6*7)"'), ANSWER.format('"42"')], "correct"),
    "answer_only": ([ANSWER.format('"42"')], "correct"),
    "boxed_answer_wrong": ([ANSWER.format('"\\\\boxed{41}"')], "wrong"),
    "plain_text_final": (["The answer is \\boxed{42}"], "correct"),
    "python_unknown_tool_then_wrong": ([PY.format('"print(40+1)"') + '<tool_call>{"name": "search", "arguments": {}}'
                                        '</tool_call>', "I think it is 41"], "wrong"),
    "blocked_code_then_nothing": ([PY.format('"import os; os.system(1)"')] * 6, "no_answer"),
    "answer_string_argument": (['<tool_call>{"name": "MathAnswer", "arguments": "\\"42\\""}</tool_call>'], "correct"),
}


@pytest.mark.parametrize("kind", ["toy", "tools"])
@pytest.mark.parametrize("finish", ["stop", "length"])
@pytest.mark.parametrize("name", sorted(ROLLOUTS))
def test_tir_rollout_equals_jax(name, finish, kind, tools_tokenizer_dir):  # noqa: F811
    """The ``tir`` preset (python shaping in ±0.2, length shaping off,
    ``max_turns`` 6) in each package: rewards, metrics, one training text
    per assistant turn with the same tokens, and the same prompts (tool
    results fed back as ``role=tool`` messages; the tools rendered where
    the template has a tools block)."""
    replies, status = ROLLOUTS[name]
    problem = {"task": "What is 6*7?", "answer": "42", "dataset": "synthetic_arithmetic", "domain": "tir"}
    overrides = ["model_path=toy", "rewards.buffer_tokens=16"] if finish == "length" else ["model_path=toy"]
    j, t = scripted_rollouts(j_rollouts.generate_tir_rollout, t_rollouts.generate_tir_rollout,
                             config_pair("tir", overrides), problem, replies,
                             kind=tools_tokenizer_dir if kind == "tools" else "toy", finish=finish)
    assert_same_rollout(j, t)
    result, prompts = t
    assert result.metrics.num_steps == len(prompts) <= 6
    assert result.metrics.success == (status == "correct")
    assert result.metrics.no_answer == (status == "no_answer")
    if kind == "tools":
        prompt = tokenizer_pair(tools_tokenizer_dir)[1].decode(prompts[-1])
        assert "<tools>" in prompt and '"name": "MathAnswer"' in prompt
        if len(prompts) > 1:
            assert "<|im_start|>tool\n" in prompt


@pytest.mark.parametrize("finish", ["stop", "length"])
@pytest.mark.parametrize("name", sorted(ROLLOUTS))
def test_phase_21_reward_gate_gives_each_rollouts_reward(name, finish):
    """``chip_smoke.tir_rewards``, phase 21's reward gate, on a rollout's
    texts as the actor writes them: its entry for the rollout's answer
    status is the reward the rollout gave, on rollouts with python calls,
    several turns and overlong turns."""
    replies, status = ROLLOUTS[name]
    problem = {"task": "What is 6*7?", "answer": "42", "dataset": "synthetic_arithmetic", "domain": "tir"}
    overrides = ["model_path=toy", "rewards.buffer_tokens=16"] if finish == "length" else ["model_path=toy"]
    cfg = config_pair("tir", overrides)[1]
    _, (result, _) = scripted_rollouts(j_rollouts.generate_tir_rollout, t_rollouts.generate_tir_rollout,
                                       config_pair("tir", overrides), problem, replies, finish=finish)
    texts = [training_text_to_sample(t, 0) for t in result.training_texts]
    rewards = tir_rewards(cfg, RewardTable.from_config(cfg), tokenizer_pair("toy")[1], texts)
    statuses = ["correct", "wrong", "no_answer", "unparsable"]
    assert all(t["reward"] == result.metrics.reward for t in texts)
    assert abs(rewards[statuses.index(status)] - result.metrics.reward) < 1e-9


# -- SandboxFusionClient against one stub server ---------------------------------


class _Stub(BaseHTTPRequestHandler):
    """A SandboxFusion stand-in: answers /run_code by the code's first
    line, and sums two stdin integers for the coding domain's scripts."""

    bodies: list = []

    def log_message(self, *args):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).bodies.append((self.path, body))
        code = body["code"]
        if "http500" in code:
            self.send_response(500)
            self.end_headers()
            return
        if "while True" in code:
            reply = {"status": "Failed", "message": "Timeout exceeded", "run_result": {"stdout": "partial\n"}}
        elif "raise" in code:
            reply = {"status": "Failed", "run_result": {"stdout": "", "stderr": "Traceback (most recent call last):\n"
                                                                                "ValueError: x\n"}}
        elif "silent" in code:
            reply = {"status": "Success", "run_result": {"stdout": ""}}
        elif "sys.stdin = io.StringIO(" in code:
            a, b = code.split("io.StringIO(")[1].split(")")[0].strip("'").split("\\n")
            reply = {"status": "Success", "run_result": {"stdout": f"{int(a) + int(b)}\n"}}
        else:
            reply = {"status": "Success", "run_result": {"stdout": "42\n", "stderr": ""}}
        data = json.dumps(reply).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)


@pytest.fixture(scope="module")
def sandbox_url():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _dead_url():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


@pytest.mark.parametrize("code", ["print(6*7)", "raise ValueError('x')", "while True: pass", "silent = 1",
                                  "http500", "import subprocess", "dead endpoint"])
def test_sandbox_client_equals_jax_on_a_stub(code, sandbox_url):
    """The same request body reaches the stub from both clients, and both
    format the reply alike; a transport error (an HTTP 500, a closed port)
    gives ``[execution error: ...]`` in both."""
    url = _dead_url() if code == "dead endpoint" else sandbox_url
    outs = []
    for mod in (j_sandbox, t_sandbox):
        _Stub.bodies.clear()
        out = asyncio.run(asyncio.wait_for(mod.SandboxFusionClient(url, timeout=5.0).execute(code), timeout=30))
        outs.append((out, list(_Stub.bodies)))
    (j_out, j_bodies), (t_out, t_bodies) = outs
    assert t_bodies == j_bodies
    if code in ("http500", "dead endpoint"):
        assert t_out.startswith("[execution error: ") and j_out.startswith("[execution error: ")
    else:
        assert t_out == j_out
        assert t_bodies == ([] if code == "import subprocess" else
                            [("/run_code", {"code": code, "language": "python", "run_timeout": 5.0})])


@pytest.mark.parametrize("name", ["python_then_answer", "python_unknown_tool_then_wrong"])
def test_tir_rollout_through_the_sandbox_equals_jax(name, sandbox_url):
    """With ``sandbox_url`` set, the python calls run on the stub (which
    prints 42) in both packages."""
    replies, _ = ROLLOUTS[name]
    problem = {"task": "What is 6*7?", "answer": "42", "dataset": "synthetic_arithmetic", "domain": "tir"}
    cfgs = config_pair("tir", ["model_path=toy", f"sandbox_url={sandbox_url}", "sandbox_timeout=5.0"])
    j, t = scripted_rollouts(j_rollouts.generate_tir_rollout, t_rollouts.generate_tir_rollout, cfgs,
                             copy.deepcopy(problem), replies)
    assert_same_rollout(j, t)
    assert t[0].metrics.num_python_calls == 1
