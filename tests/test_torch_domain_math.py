"""The port's math domain against the JAX package's: the verifier on every
case of ``tests/test_math_domain.py`` and on hypothesis-built answers, the
synthetic sets and local files item for item, the reward table and length
penalty over a grid, and rollouts under one scripted LLM (same reward,
metrics and training-text token ids) on the toy and the fixture tokenizers.
Also the helpers the other domains' parity tests share."""

import asyncio
import copy
import json
from concurrent.futures import Future
from pathlib import Path

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pipelinerl_tpu.config import compose as j_compose
from pipelinerl_tpu.domains.math.load_datasets import load_datasets as j_load_datasets
from pipelinerl_tpu.domains.math import rollouts as j_rollouts
from pipelinerl_tpu.domains.math import verifier as j_verifier
from pipelinerl_tpu.inference import engine as j_engine
from pipelinerl_tpu.inference.client import InProcessLLM as JInProcessLLM
from pipelinerl_tpu.models.toy_tokenizer import ToyTokenizer as JToyTokenizer
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.domains.math.load_datasets import load_datasets as t_load_datasets
from pipelinerl_tpu_torch.domains.math import rollouts as t_rollouts
from pipelinerl_tpu_torch.domains.math import verifier as t_verifier
from pipelinerl_tpu_torch.inference import engine as t_engine
from pipelinerl_tpu_torch.inference.client import InProcessLLM
from pipelinerl_tpu_torch.models.hf_tokenizer import HFTokenizer
from pipelinerl_tpu_torch.models.toy_tokenizer import ToyTokenizer
from tests.test_torch_domains import assert_same_rollout

torch.set_num_threads(1)
FIXTURE = Path(__file__).resolve().parents[1] / "pipelinerl_tpu_torch" / "fixtures" / "hf_tokenizer"

# -- helpers shared by the domain parity tests ---------------------------------


class ScriptedEngine:
    """An engine stand-in that answers each request with the next scripted
    token ids, as a ``GenResult`` of ``mod`` with ``finish``."""

    def __init__(self, mod, replies, finish):
        self.mod, self.replies, self.finish = mod, list(replies), finish
        self.prompts = []

    def submit(self, request):
        self.prompts.append(list(request.prompt_ids))
        ids = self.replies.pop(0)
        future = Future()
        future.set_result(self.mod.GenResult(ids, [-0.25] * len(ids), self.finish, 3, 4, len(request.prompt_ids)))
        return future

    def abort(self, request_id):
        pass


def tokenizer_pair(kind):
    """(JAX side, port side): the toy tokenizers, or the committed fixture
    tokenizer ("fixture", or a directory holding a copy of it) read by
    transformers and by the port."""
    if kind == "toy":
        return JToyTokenizer(), ToyTokenizer()
    from transformers import AutoTokenizer

    directory = FIXTURE if kind == "fixture" else kind
    return AutoTokenizer.from_pretrained(str(directory)), HFTokenizer(directory)


def config_pair(name: str, overrides=()):
    """The preset ``name`` composed by each package."""
    overrides = ["output_dir=/tmp/unused", *overrides]
    return j_compose("conf", name, overrides), compose(name, overrides)


def scripted_rollouts(j_fn, t_fn, cfgs, problem, replies, kind="toy", finish="stop", max_tokens=64):
    """One rollout of ``problem`` in each package, the LLM answering with
    ``replies`` (text, then EOS when ``finish`` is "stop"). Returns [(result,
    prompts)] for JAX, then the port."""
    j_tok, t_tok = tokenizer_pair(kind)
    reply_ids = [t_tok.encode(r) + ([t_tok.eos_token_id] if finish == "stop" else []) for r in replies]
    out = []
    for mod, llm_cls, tok, fn, cfg in ((j_engine, JInProcessLLM, j_tok, j_fn, cfgs[0]),
                                       (t_engine, InProcessLLM, t_tok, t_fn, cfgs[1])):
        engine = ScriptedEngine(mod, copy.deepcopy(reply_ids), finish)
        llm = llm_cls(engine, tok, {"max_tokens": max_tokens})
        out.append((asyncio.run(fn(cfg, llm, copy.deepcopy(problem), None)), engine.prompts))
    return out


def outcome(fn, *args):
    """``fn(*args)``'s value, or the type of what it raised: the port must
    fail where JAX's fails, too."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - compared across the packages
        return type(e)


# -- the verifier -------------------------------------------------------------

EQUAL = [("42", "42"), (" 42 ", "42."), (r"\frac{1}{2}", "0.5"), ("1/2", "2/4"), ("1,000", "1000"), (r"\$5", "5"),
         ("50\\%", "0.5"), ("(1, 2)", "(1,2)"), (r"\text{east}", "east"), ("2*3", "6"), (r"\sqrt{4}", "2"),
         ("-0.25", "-1/4")]
NOT_EQUAL = [("41", "42"), ("1/3", "0.5"), ("(1,2)", "(2,1)"), ("east", "west")]
GRADE = [(r"the answer is \boxed{6}", r"\boxed{6}"), (r"\boxed{5}", "6"), ("I cannot solve this", "6"), ("", "6"),
         (r"thus \boxed{\frac{1}{2}}", "0.5"), (r"a \boxed{1} then \boxed{2}", "2"), ("The final answer is 42", "42"),
         ("<answer>7</answer>", "7"), (r"so \boxed{x+1}", "x+1"), ("I don't know", "x")]
COUNTDOWN = [("<answer>(3+5)*2</answer>", [3, 5, 2], 16), ("<answer>3*5*2</answer>", [3, 5, 2], 16),
             ("<answer>(3+5)*4</answer>", [3, 5, 2], 16), ("no expr here", [3, 5, 2], 16),
             ("<answer>3 \\times 5 + 2 - 1</answer>", [3, 5, 2, 1], 16), ("<answer>import os</answer>", [1], 1),
             ("<answer>(3+5)/0*2</answer>", [3, 5, 0, 2], 16)]


@pytest.mark.parametrize("pred,gold", EQUAL + NOT_EQUAL + [(g, p) for p, g in GRADE])
def test_verifier_functions_equal_jax(pred, gold):
    for name in ("extract_boxed", "extract_answer", "normalize_answer"):
        assert getattr(t_verifier, name)(pred) == getattr(j_verifier, name)(pred), name
    assert t_verifier.answers_equal(pred, gold) == j_verifier.answers_equal(pred, gold)
    assert t_verifier.grade_answer(pred, gold) == j_verifier.grade_answer(pred, gold)
    assert t_verifier.grade_answer(gold, pred) == j_verifier.grade_answer(gold, pred)


def test_jax_test_cases_hold_on_the_port():
    assert all(t_verifier.answers_equal(p, g) for p, g in EQUAL)
    assert not any(t_verifier.answers_equal(p, g) for p, g in NOT_EQUAL)
    assert [t_verifier.grade_answer(p, g) for p, g in GRADE[:4]] == ["correct", "wrong", "no_answer", "no_answer"]
    assert [t_verifier.verify_countdown(*c) for c in COUNTDOWN[:4]] == ["correct", "wrong", "wrong", "no_answer"]


@pytest.mark.parametrize("case", COUNTDOWN)
def test_verify_countdown_equals_jax(case):
    assert t_verifier.verify_countdown(*case) == j_verifier.verify_countdown(*case)


_ATOMS = st.sampled_from(["1", "2", "42", "-3", "0.5", "1/2", "\\frac{1}{2}", "\\pi", "x", "(1,2)", "1,000", "50\\%",
                          "\\sqrt{4}", "\\text{east}", "2*3", "1e3", "{", "}", "\\boxed{", " ", "$", ".", ","])
_ANSWERS = st.one_of(st.lists(_ATOMS, max_size=6).map("".join), st.text(max_size=20))


@settings(max_examples=300, deadline=None)
@given(pred=_ANSWERS, gold=_ANSWERS, wrap=st.sampled_from(["{}", "\\boxed{{{}}}", "<answer>{}</answer>",
                                                            "The final answer is {}"]))
def test_grade_answer_equals_jax_on_built_answers(pred, gold, wrap):
    text = wrap.format(pred)
    assert outcome(t_verifier.grade_answer, text, gold) == outcome(j_verifier.grade_answer, text, gold)
    assert t_verifier.normalize_answer(pred) == j_verifier.normalize_answer(pred)


def test_an_answer_past_the_float_range_raises_in_both_packages():
    """A shared fault (ROADMAP Queue 3): ``_to_number`` catches ValueError
    and ZeroDivisionError but not the OverflowError of a float past 1e308."""
    for verifier in (t_verifier, j_verifier):
        with pytest.raises(OverflowError):
            verifier.grade_answer("\\boxed{1}", "1e350\\%")


@settings(max_examples=200, deadline=None)
@given(expr=st.lists(st.sampled_from(list("0123456789+-*/() .") + ["12", "30", "x"]),
                     max_size=12).map("".join),
       numbers=st.lists(st.integers(0, 30), min_size=1, max_size=4), target=st.integers(-50, 900))
def test_verify_countdown_equals_jax_on_built_expressions(expr, numbers, target):
    text = f"<answer>{expr}</answer>"
    assert outcome(t_verifier.verify_countdown, text, numbers, target) == outcome(
        j_verifier.verify_countdown, text, numbers, target)


# -- datasets -----------------------------------------------------------------


@pytest.mark.parametrize("names,seed", [(["synthetic_arithmetic", "countdown"], None),
                                        (["countdown", "synthetic_arithmetic_b", "countdown"], 7)])
def test_synthetic_sets_equal_jax(names, seed):
    ours = t_load_datasets(names, seed=seed)
    assert ours == j_load_datasets(names, seed=seed)
    assert len(ours) == 512 + 256


def test_local_files_equal_jax(tmp_path):
    rows = [{"problem": "What is 1+1?", "answer": "2"}, {"question": "q", "solution": "s", "level": "3"},
            {"problem": "dropped"}, {"task": "t", "answer": "\\boxed{3}", "dataset": "orig"}]
    (tmp_path / "custom.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    (tmp_path / "more.json").write_text(json.dumps(rows))
    names = [str(tmp_path / "custom.jsonl"), str(tmp_path / "more.json")]
    assert t_load_datasets(names) == j_load_datasets(names)
    assert t_load_datasets(names[:1])[0] == {"task": "What is 1+1?", "answer": "\\boxed{2}", "dataset": "custom",
                                                  "domain": "math", "id": 0}


@pytest.mark.parametrize("name", ["open_reasoner_zero_57k", "math_500", "aime_2024", "amc_2023_original",
                                  "org/some_dataset"])
def test_hub_names_raise_naming_the_missing_files(name):
    with pytest.raises(ValueError, match="not in the repository"):
        t_load_datasets([name])


def test_parquet_and_unknown_names_raise(tmp_path):
    (tmp_path / "x.parquet").write_bytes(b"")
    with pytest.raises(ValueError, match="not in the repository"):
        t_load_datasets([str(tmp_path / "x.parquet")])
    with pytest.raises(ValueError, match="Unknown math dataset"):
        t_load_datasets(["not_a_dataset_xyz"])


# -- rewards ------------------------------------------------------------------


@pytest.mark.parametrize("rewards", ["base", "success", "pure_success"])
def test_reward_table_and_length_penalty_equal_jax(rewards):
    j_table = j_rollouts.RewardTable(**dict(j_compose("conf/rewards", rewards).items()))
    t_table = t_rollouts.RewardTable.from_config(compose("math", ["output_dir=/tmp/unused", f"rewards={rewards}"]))
    assert t_table.__dict__ == j_table.model_dump()
    for status in ("correct", "wrong", "no_answer", "unparsable"):
        for finished in (True, False):
            assert t_rollouts.get_reward(status, finished, t_table) == j_rollouts.get_reward(status, finished, j_table)
    for max_length in (16, 100, 1000):
        for buffer in (1, 7, 16, 100):
            for n in range(0, max_length + 20, 3):
                assert t_rollouts.length_penalty(max_length, n, buffer) == j_rollouts.length_penalty(max_length, n, buffer)


# -- rollouts -----------------------------------------------------------------

ARITH = {"task": "What is 12 + 30?", "answer": "\\boxed{42}", "dataset": "synthetic_arithmetic", "domain": "math",
         "id": 3}
COUNT = {"task": "Using the numbers [3, 5, 2] ...", "numbers": [3, 5, 2], "target": 16, "answer": "16",
         "dataset": "countdown", "domain": "math", "id": 0}


@pytest.mark.parametrize("kind", ["toy", "fixture"])
@pytest.mark.parametrize("problem,reply,finish,status", [
    (ARITH, "so the answer is \\boxed{42}", "stop", "correct"),
    (ARITH, "\\boxed{41}", "stop", "wrong"),
    (ARITH, "I do not know", "stop", "no_answer"),
    (ARITH, "\\boxed{42} and then some more", "length", "correct"),
    (COUNT, "<answer>(3+5)*2</answer>", "stop", "correct"),
    (COUNT, "<answer>import os</answer>", "length", "unparsable"),
])
def test_math_rollout_equals_jax(kind, problem, reply, finish, status):
    j, t = scripted_rollouts(j_rollouts.generate_math_rollout, t_rollouts.generate_math_rollout,
                             config_pair("math"), problem, [reply], kind=kind, finish=finish)
    assert_same_rollout(j, t)
    result = t[0]
    table = t_rollouts.RewardTable()
    assert result.metrics.reward == t_rollouts.get_reward(status, finish == "stop", table)
    assert result.metrics.success == (status == "correct") and result.metrics.penalty == 0.0


@pytest.mark.parametrize("kind", ["toy", "fixture"])
@pytest.mark.parametrize("finish", ["stop", "length"])
def test_math_rollout_with_discount_and_overlong_penalty_equals_jax(kind, finish):
    """A reply inside the last ``buffer_tokens`` of the budget: the
    discount per token and the overlong penalty, both packages alike."""
    _, t_tok = tokenizer_pair(kind)
    reply = "the answer is \\boxed{42}, so 42 it is"
    n = len(t_tok.encode(reply)) + (finish == "stop")
    cfgs = config_pair("math", ["rewards.buffer_tokens=8", "actor.discount_factor=0.99"])
    j, t = scripted_rollouts(j_rollouts.generate_math_rollout, t_rollouts.generate_math_rollout, cfgs, ARITH,
                             [reply], kind=kind, finish=finish, max_tokens=n + 2)
    assert_same_rollout(j, t)
    assert t[0].metrics.penalty == pytest.approx(-(n - (n + 2 - 8)) / 8)
    assert t[1] and "Please reason step by step" in t_tok.decode(t[1][0])

