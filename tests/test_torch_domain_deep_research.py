"""The port's deep_research domain against the JAX package's: the corpus and
its questions for several seeds, search and read, the problem sets, and
rollouts under one scripted LLM (same rewards, ``model_dump`` metrics and
training-text tokens: a two-hop success, a wrong answer, a rambler that hits
``max_loops``, invalid actions, a missing document). The corpus served over
HTTP is held against JAX's in ``tests/test_torch_environments.py``. Mirrors
``tests/test_deep_research_domain.py``."""

import pytest

from pipelinerl_tpu.config import Config as JConfig
from pipelinerl_tpu.domains.deep_research import environment as j_env
from pipelinerl_tpu.domains.deep_research import rollouts as j_rollouts
from pipelinerl_tpu_torch.config import Config, compose
from pipelinerl_tpu_torch.domains.deep_research import environment as t_env
from pipelinerl_tpu_torch.domains.deep_research import rollouts as t_rollouts
from pipelinerl_tpu_torch.domains.registry import resolve, resolve_domain_rollout
from tests.test_torch_domain_math import scripted_rollouts
from tests.test_torch_domains import assert_same_rollout


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_corpus_search_and_read_equal_jax(seed):
    (t_corpus, t_questions), (j_corpus, j_questions) = t_env.build_corpus(seed=seed), j_env.build_corpus(seed=seed)
    assert t_corpus.documents == j_corpus.documents and t_questions == j_questions
    queries = [q["task"] for q in j_questions[:6]] + ["Biography", "institute of hydrology", "a b", "", "Zorland"]
    for query in queries:
        assert t_corpus.search(query) == j_corpus.search(query)
        assert t_corpus.search(query, k=2) == j_corpus.search(query, k=2)
    for doc_id in ["doc_0a", "doc_3b", "doc_23c", "nope"]:
        assert t_corpus.read(doc_id) == j_corpus.read(doc_id)


@pytest.mark.parametrize("names,kw", [(["train"], {"max_examples": 16}), (["test"], {}), (["train", "test"], {}),
                                      (["my_train_set"], {"max_examples": 5})])
def test_load_problems_equal_jax(names, kw):
    assert t_env.load_problems(names, **kw) == j_env.load_problems(names, **kw)


def test_jax_test_cases_hold_on_the_port():
    corpus, questions = t_env.build_corpus(seed=0)
    person = questions[0]["task"].removeprefix("In what year was ").removesuffix(" born?")
    hits = corpus.search(person)
    assert hits and questions[0]["answer"] in corpus.read(hits[0]["id"])
    train, test = t_env.load_problems(["train"], max_examples=16), t_env.load_problems(["test"], max_examples=16)
    assert len(train) == len(test) == 16 and train[0]["corpus_seed"] == 0 and test[0]["corpus_seed"] == 1
    assert all(p["domain"] == "deep_research" for p in train)


def _cfgs(**actor):
    actor = {"max_loops": 6, "step_cost": 0.05, **actor}
    return JConfig({"actor": actor}), Config({"actor": actor})


def _person(problem):
    return problem["task"].removeprefix("In what year was ").removesuffix(" born?")


def _scripts():
    """name -> (problem, replies, reward)."""
    corpus, questions = t_env.build_corpus(seed=0)
    one_hop = {**questions[0], "dataset": "train", "domain": "deep_research", "corpus_seed": 0}
    two_hop = {**questions[1], "dataset": "train", "domain": "deep_research", "corpus_seed": 0}
    hit = corpus.search(_person(one_hop))[0]["id"]
    return {
        "two_step_success": (one_hop, [f"Let me look. <search>{_person(one_hop)}</search>", f"<read>{hit}</read>",
                                       f"Found it. <answer>{one_hop['answer']}</answer>"], 0.9),
        "wrong": (one_hop, ["<answer>not it</answer>"], -0.5),
        "rambler": (one_hop, ["hmm"] * 6, -1.0),
        "missing_doc_then_answer": (two_hop, ["<read>doc_999z</read>", "<search>institute</search>",
                                              f"The city is <answer> {two_hop['answer']}. </answer>"], 0.9),
        "no_results_then_wrong": (two_hop, ["<search>xy</search>", "<answer>Nowhere</answer>"], -0.55),
    }


@pytest.mark.parametrize("finish", ["stop", "length"])
@pytest.mark.parametrize("name", sorted(_scripts()))
def test_research_rollout_equals_jax(name, finish):
    problem, replies, reward = _scripts()[name]
    j, t = scripted_rollouts(j_rollouts.generate_research_rollout, t_rollouts.generate_research_rollout, _cfgs(),
                             problem, replies, finish=finish)
    assert_same_rollout(j, t)
    result, prompts = t
    assert result.metrics.reward == pytest.approx(reward)
    assert len(result.training_texts) == len(prompts) == len(replies)
    assert all(text.reward == result.metrics.reward for text in result.training_texts)
    assert result.metrics.overflow == (finish == "length")


def test_base_preset_resolves_the_research_functions():
    """The ``base`` preset with the policy and loader overridden to this
    domain's (JAX's launch takes the same overrides; there is no preset)."""
    cfg = compose("base", ["output_dir=/tmp/unused",
                           "rollout_policy=pipelinerl_tpu_torch.domains.deep_research.generate_research_rollout",
                           "dataset_loader=pipelinerl_tpu_torch.domains.deep_research.load_problems"])
    problems = resolve(cfg.dataset_loader)(list(cfg.train_dataset_names))
    assert len(problems) == 48 and {p["domain"] for p in problems} == {"deep_research"}
    assert resolve(cfg.rollout_policy) is resolve_domain_rollout("deep_research")
