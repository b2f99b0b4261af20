"""The port's logic domain against the JAX package's: the synthetic sets
item for item, every ``VERIFIERS`` type on the oracle answer and on wrong,
empty and malformed ones, ``extract_answer`` and the AST walkers, and
rollouts under one scripted LLM on the toy and the fixture tokenizers."""

import pytest

from pipelinerl_tpu.domains.logic import dataset as j_dataset
from pipelinerl_tpu.domains.logic import rollouts as j_rollouts
from pipelinerl_tpu.domains.logic import verifiers as j_verifiers
from pipelinerl_tpu_torch.domains.logic import dataset as t_dataset
from pipelinerl_tpu_torch.domains.logic import rollouts as t_rollouts
from pipelinerl_tpu_torch.domains.logic import verifiers as t_verifiers
from tests.test_logic_domain import _oracle
from tests.test_torch_domain_math import config_pair, outcome, scripted_rollouts
from tests.test_torch_domains import assert_same_rollout


@pytest.mark.parametrize("names", [["train"], ["test"], ["logic_train", "logic_test"]])
def test_synthetic_sets_equal_jax(names):
    ours = t_dataset.load_problems(names)
    assert ours == j_dataset.load_problems(names)
    assert len(ours) == 512 * len(names)
    assert t_dataset.load_problems(["train"], max_examples=20) == j_dataset.load_problems(["train"], max_examples=20)
    assert t_dataset.generate_problems(37, seed=5, tasks=["sudoku", "navigation"]) == \
        j_dataset.generate_problems(37, seed=5, tasks=["sudoku", "navigation"])


def test_hub_and_unknown_sets_raise():
    with pytest.raises(ValueError, match="not in the repository"):
        t_dataset.load_problems(["intellect3@train"])
    with pytest.raises(ValueError, match="unknown logic dataset"):
        t_dataset.load_problems(["nope"])


def _predictions(task, game_data):
    answer = _oracle(task, game_data)
    return [f"Reasoning...\n<answer>{answer}</answer>", f"\\boxed{{{answer}}}", f"Final answer: {answer}",
            "<answer>definitely not it</answer>", "<answer>42</answer>", "<answer>yes</answer>",
            "<answer>A=1, B=2</answer>", "no answer here", "", "   "]


@pytest.mark.parametrize("task", sorted(t_verifiers.VERIFIERS))
def test_every_verifier_equals_jax(task):
    problems = [p for p in t_dataset.generate_problems(180, seed=3) if p["reward_context"]["task"] == task]
    if task == "cryptarithm":  # no generator: the JAX test's puzzle
        problems = [{"reward_context": {"task": task, "game_data": {"words": ["AB", "BA"], "result": "CC"}}}]
        preds = ["<answer>A=1, B=2, C=3</answer>", "<answer>A=1, B=1, C=2</answer>", "<answer>A=0, B=2, C=2</answer>",
                 "<answer>A=1</answer>", ""]
    for p in problems:
        ctx = p["reward_context"]
        for pred in preds if task == "cryptarithm" else _predictions(ctx["task"], ctx["game_data"]):
            assert t_verifiers.verify_answer(pred, ctx) == j_verifiers.verify_answer(pred, ctx), (ctx, pred)
            v_t, v_j = t_verifiers.VERIFIERS[task], j_verifiers.VERIFIERS[task]
            assert outcome(v_t.verify, ctx["game_data"], pred) == outcome(v_j.verify, ctx["game_data"], pred)
    if task != "cryptarithm":
        ctx = problems[0]["reward_context"]
        assert t_verifiers.verify_answer(_predictions(task, ctx["game_data"])[0], ctx) == "correct"


def test_registry_edges_and_walkers_equal_jax():
    ctxs = [{}, {"task": "nope", "game_data": {}}, {"task": "sudoku", "game_data": {"puzzle": []}},
            {"task": "multistep_arithmetic", "game_data": {"expression": "__import__('os')"}}]
    for ctx in ctxs:
        for pred in ("<answer>1234</answer>", ""):
            assert t_verifiers.verify_answer(pred, ctx) == j_verifiers.verify_answer(pred, ctx)
    for text in ("<answer> a </answer> <answer>b</answer>", "\\boxed{x} \\boxed{y}", "answer = 7\nmore", "none"):
        assert t_verifiers.extract_answer(text) == j_verifiers.extract_answer(text)
    for expr in ("(True) and (not (False))", "True or __import__('os')", "1 if True else 0"):
        assert outcome(t_verifiers._safe_bool_eval, expr) == outcome(j_verifiers._safe_bool_eval, expr)
    for expr in ("((3 * -2) - (4 + 1))", "2 ** 8", "open('x')", "-(-7)"):
        assert outcome(t_verifiers._safe_int_eval, expr) == outcome(j_verifiers._safe_int_eval, expr)


@pytest.mark.parametrize("kind", ["toy", "fixture"])
@pytest.mark.parametrize("index,right,finish", [(0, True, "stop"), (1, False, "stop"), (2, True, "length"),
                                                (3, False, "length")])
def test_logic_rollout_equals_jax(kind, index, right, finish):
    problem = t_dataset.load_problems(["train"], max_examples=8)[index]
    ctx = problem["reward_context"]
    reply = f"<answer>{_oracle(ctx['task'], ctx['game_data'])}</answer>" if right else "<answer>?</answer>"
    j, t = scripted_rollouts(j_rollouts.generate_logic_rollout, t_rollouts.generate_logic_rollout,
                             config_pair("logic", ["rewards.buffer_tokens=4"]), problem, [reply], kind=kind,
                             finish=finish)
    assert_same_rollout(j, t)
    assert t[0].metrics.success == right
