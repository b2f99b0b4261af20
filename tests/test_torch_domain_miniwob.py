"""The port's miniwob domain against the JAX package's: the simulated tasks
built from the same seeds, the same episodes under an oracle and under
wrong actions, ``compute_reward`` under both modes, the task splits, and
rollouts in process under one scripted LLM (same rewards, ``model_dump``
metrics but the wall time, and training-text tokens), and the penalized
result of an all-servers-down pool. The server pool itself is held against
JAX's in ``tests/test_torch_environments.py``. Mirrors
``tests/test_miniwob_domain.py``."""

import itertools
import time

import pytest

from pipelinerl_tpu.config import Config as JConfig
from pipelinerl_tpu.domains.miniwob.load_tasks import load_tasks as j_load_tasks
from pipelinerl_tpu.domains.miniwob import rollouts as j_rollouts
from pipelinerl_tpu.domains.miniwob import simulated_env as j_env
from pipelinerl_tpu_torch.config import Config
from pipelinerl_tpu_torch.domains.miniwob.load_tasks import load_tasks as t_load_tasks
from pipelinerl_tpu_torch.domains.miniwob import rollouts as t_rollouts
from pipelinerl_tpu_torch.domains.miniwob import simulated_env as t_env
from tests.test_torch_domain_math import config_pair, scripted_rollouts
from tests.test_torch_domains import assert_same_rollout


def _solve(env) -> list[str]:
    """The oracle's actions for any simulated task (the JAX test's)."""
    goal, dom = env.task.goal, env.task.dom
    if "Click the" in goal and "button" in goal:
        target = goal.split('"')[1]
        return [f'click("{next(b for b, el in dom.items() if el.get("text") == target)}")']
    if goal.startswith("Check the boxes"):
        wanted = set(goal.split("labeled ")[1].split(" then")[0].split(", "))
        return [f'click("{b}")' for b, el in dom.items() if el["tag"] == "checkbox" and el["text"] in wanted] + \
               ['click("submit")']
    if goal.startswith("Type"):
        return [f'fill("input", "{goal.split(chr(34))[1]}")', 'click("submit")']
    if goal.startswith("Select"):
        return [f'select_option("list", "{goal.split(chr(34))[1]}")', 'click("submit")']
    raise AssertionError(goal)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("task", sorted(j_env.TASKS))
def test_simulated_episodes_equal_jax(task, seed):
    """The same goal and DOM from the same seed; an oracle episode and a
    wrong one give the same observations, done flags and infos step by
    step, and end on +1 and -1."""
    assert sorted(t_env.TASKS) == sorted(j_env.TASKS)
    wrong = ['click("nonexistent")', "gibberish", 'fill("b0", "x")', 'select_option("submit", "y")']
    for actions in (None, wrong * 3):
        envs = (j_env.SimulatedWebEnv(task_name=task, seed=seed), t_env.SimulatedWebEnv(task_name=task, seed=seed))
        assert envs[1].task.goal == envs[0].task.goal and envs[1].task.dom == envs[0].task.dom
        assert envs[1].observe() == envs[0].observe()
        steps = []
        for action in actions or _solve(envs[0]):
            out = [env.step(action) for env in envs]
            assert out[1] == out[0]
            steps.append(out[1])
            if out[1][1]:
                break
        assert steps[-1][1] and steps[-1][2]["task_info"]["REWARD_GLOBAL"] == (1.0 if actions is None else -1.0)
    with pytest.raises(KeyError):
        t_env.SimulatedWebEnv(task_name="nope", seed=0)


def test_compute_reward_equals_jax():
    grid = itertools.product([1.0, 0.5, 0.0, -1.0], [True, False], [0, 1, 3], [1, 4], ["nico", "uic"])
    for args in grid:
        assert t_rollouts.compute_reward(*args) == j_rollouts.compute_reward(*args)
    assert t_rollouts.compute_reward(1.0, True, 2, 3, "nico") == pytest.approx(0.99**2)
    assert t_rollouts.compute_reward(0.0, True, 0, 3, "uic") == pytest.approx(-(0.98**3))
    with pytest.raises(ValueError):
        t_rollouts.compute_reward(1.0, True, 0, 0, "bogus")


@pytest.mark.parametrize("names,kw", [(["simweb_train"], {"n_seeds": 4}), (["simweb_test"], {"n_seeds": 2}),
                                      (["simweb_train", "debug", "easy"], {}), (["simweb_test"], {})])
def test_load_tasks_equal_jax(names, kw):
    assert t_load_tasks(names, **kw) == j_load_tasks(names, **kw)
    with pytest.raises(ValueError):
        t_load_tasks(["nope"])


def _scripts():
    """name -> (problem, replies, reward under nico)."""
    enter = {"task": "simweb.enter-text", "seed": 1, "dataset": "simweb_train", "domain": "miniwob"}
    boxes = {"task": "simweb.click-checkboxes", "seed": 5, "dataset": "simweb_train", "domain": "miniwob"}
    oracle = _solve(t_env.SimulatedWebEnv(task_name=enter["task"], seed=1))
    boxes_oracle = _solve(t_env.SimulatedWebEnv(task_name=boxes["task"], seed=5))
    return {
        "success": (enter, [f"I will act. {a}" for a in oracle], 1.0),
        "step_errors": (enter, ["gibberish no action here"] + [f"ok {a}" for a in oracle], 0.99**2),
        "wrong_then_submit": (enter, ['fill("input", "nope")', 'click("submit")'], -1.0),
        "checkboxes": (boxes, boxes_oracle, 1.0),
        "out_of_loops": (boxes, ['click("c0")'] * 8, -1.0),
    }


def _without_wall_time(pair):
    for result, _ in pair:
        result.metrics.total_execution_time = 0.0
    return pair


@pytest.mark.parametrize("mode", ["nico", "uic"])
@pytest.mark.parametrize("name", sorted(_scripts()))
def test_miniwob_rollout_equals_jax(name, mode):
    """The ``miniwob`` preset (``agent_max_loops`` 8), the simulated env in
    process in both packages."""
    problem, replies, reward = _scripts()[name]
    j, t = _without_wall_time(scripted_rollouts(
        j_rollouts.generate_miniwob_rollout, t_rollouts.generate_miniwob_rollout,
        config_pair("miniwob", ["model_path=toy", f"actor.reward_computation={mode}"]), problem, replies))
    assert_same_rollout(j, t)
    result, prompts = t
    if mode == "nico":
        assert result.metrics.reward == pytest.approx(reward)
    assert len(result.training_texts) == len(prompts) <= 8
    assert all(text.reward == result.metrics.reward for text in result.training_texts)


def test_jax_test_cases_hold_on_the_port():
    problem, replies, _ = _scripts()["step_errors"]
    cfg = (JConfig({"actor": {"agent_max_loops": 6, "reward_computation": "nico"}}),
           Config({"actor": {"agent_max_loops": 6, "reward_computation": "nico"}}))
    j, t = _without_wall_time(scripted_rollouts(j_rollouts.generate_miniwob_rollout,
                                                t_rollouts.generate_miniwob_rollout, cfg, problem, replies))
    assert_same_rollout(j, t)
    # one unparsable action counts twice: the parse and the env's action error
    assert t[0].metrics.n_step_errors == 2 and t[0].metrics.reward == pytest.approx(0.99**2)
    assert len(t_load_tasks(["simweb_train"], n_seeds=4)) == 16
    assert all(p["seed"] >= 10_000 for p in t_load_tasks(["simweb_test"], n_seeds=2))


def test_failed_rollout_equals_jax():
    """The pool's all-servers-down result (its callers are in
    ``tests/test_torch_environments.py``)."""
    problem, _, _ = _scripts()["success"]
    start = time.time()
    j_failed, t_failed = j_rollouts._failed_rollout(problem, start), t_rollouts._failed_rollout(problem, start)
    assert t_failed.training_texts == j_failed.training_texts == []
    assert (t_failed.domain, t_failed.dataset_name) == (j_failed.domain, j_failed.dataset_name)
    for r in (j_failed, t_failed):
        r.metrics.total_execution_time = 0.0
    assert t_failed.metrics.model_dump() == j_failed.metrics.model_dump()
    assert t_failed.metrics.reward == -1.0 and not t_failed.metrics.no_error
