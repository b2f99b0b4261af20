"""Domain-mix sampling and the difficulty-aware penalty against the JAX
package: ``DomainWeightedSampler`` draws the same 500 problems from the same
seed across its switch to adaptive weights, ``load_multidomain`` loads the
same problems and dispatch reaches each domain's rollout, and the actor's
``_apply_difficulty_aware_penalty`` gives the same rewards on the same
results."""

import random
from types import SimpleNamespace

import pytest

from pipelinerl_tpu import actor as j_actor
from pipelinerl_tpu import domain_sampling as j_sampling
from pipelinerl_tpu import types as j_types
from pipelinerl_tpu.domains import registry as j_registry
from pipelinerl_tpu_torch import actor as t_actor
from pipelinerl_tpu_torch import domain_sampling as t_sampling
from pipelinerl_tpu_torch import types as t_types
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.domains import registry as t_registry
from tests.test_torch_domain_math import config_pair, scripted_rollouts
from tests.test_torch_domains import assert_same_rollout

NAMES = ["math::synthetic_arithmetic", "math::countdown", "guessing::train", "counting::train", "bandit::b"]


def test_load_multidomain_equals_jax():
    ours = t_sampling.load_multidomain(NAMES)
    assert ours == j_sampling.load_multidomain(NAMES)
    assert {p["domain"] for p in ours} == {"math", "guessing", "counting", "bandit"}
    with pytest.raises(ValueError, match="domain::dataset"):
        t_sampling.load_multidomain(["no_double_colon"])
    with pytest.raises(ValueError, match="not in the repository"):
        t_sampling.load_multidomain(["chartqa::train"])
    with pytest.raises(ValueError, match="unknown domain"):
        t_sampling.load_multidomain(["tir::x"])
    with pytest.raises(ValueError, match="not in the repository"):
        t_sampling.load_multidomain(["math::open_reasoner_zero_57k"])


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("weights", [{"math": 0.6, "guessing": 0.2, "counting": 0.2, "bandit": 0.5},
                                     {"math": 3, "guessing": 1, "counting": 1e-3, "bandit": 0}])
def test_sampler_draws_equal_jax_across_the_adaptive_switch(weights, adaptive):
    problems = t_sampling.load_multidomain(NAMES)
    samplers = [mod.DomainWeightedSampler(problems, weights, rng=random.Random(42), adaptive=adaptive)
                for mod in (j_sampling, t_sampling)]
    skew = random.Random(7)
    draws = [[], []]
    for _ in range(500):
        for sampler, out in zip(samplers, draws):
            out.append(sampler.sample())
        # complete math 3x as often as drawn, the others once: adaptive weights
        # move once 50 completions are in
        domain = draws[0][-1]["domain"]
        for _ in range(3 if domain == "math" else 1 if skew.random() < 0.7 else 0):
            for sampler in samplers:
                sampler.record_completion(domain)
    assert draws[0] == draws[1]
    assert samplers[1].total_completions > t_sampling.MIN_COMPLETIONS_FOR_ADJUSTMENT
    assert samplers[1]._weights_now() == samplers[0]._weights_now()
    assert (samplers[1]._weights_now() != samplers[1].base_weights) == adaptive


def test_sampler_validation_equals_jax():
    problems = t_sampling.load_multidomain(NAMES[:3])
    for weights in ({}, {"math": 1.0}, {"math": 1.0, "guessing": 1.0, "tir": 1.0}, {"math": -1, "guessing": 1},
                    {"math": 0, "guessing": 0}):
        for mod in (j_sampling, t_sampling):
            with pytest.raises(ValueError):
                mod.DomainWeightedSampler(problems, weights)
    with pytest.raises(ValueError, match="'domain' field"):
        t_sampling.DomainWeightedSampler([{"id": 1}], {"math": 1})


def test_multi_domain_preset_draws_every_domain_first():
    """Inline, the actor submits ``max_parallel_groups`` groups before any
    completes, so the first 16 draws from ``Random(seed)`` decide which
    domains a short run reaches: the smoke's cut of the preset reaches all
    three."""
    cfg = compose("multi_domain", ["output_dir=/tmp/unused", "model_path=/tmp/m",
                                   "train_dataset_names=[math::synthetic_arithmetic,math::countdown,guessing::train,"
                                   "counting::train]"])
    problems = t_sampling.load_multidomain(list(cfg.train_dataset_names))
    sampler = t_sampling.DomainWeightedSampler(problems, dict(cfg.domain_mix.items()), rng=random.Random(cfg.seed))
    assert {sampler.sample()["domain"] for _ in range(cfg.actor.max_parallel_groups)} == {"math", "guessing",
                                                                                          "counting"}


@pytest.mark.parametrize("problem,reply", [
    ({"task": "What is 1 + 1?", "answer": "\\boxed{2}", "dataset": "synthetic_arithmetic", "domain": "math"},
     "\\boxed{2}"),
    ({"word": "banana", "letter": "a", "count": 3, "dataset": "train", "domain": "counting"}, "<answer>3</answer>"),
    ({"answer": 383, "dataset": "train", "domain": "guessing"}, "<answer>383</answer>"),
    ({"prompt": "say x", "target": "x", "dataset": "b", "domain": "bandit"}, "x"),
])
def test_dispatch_reaches_each_domain_as_jax(problem, reply):
    j, t = scripted_rollouts(j_registry.generate_dispatched_rollout, t_registry.generate_dispatched_rollout,
                             config_pair("multi_domain", ["model_path=toy"]), problem, [reply])
    assert_same_rollout(j, t)
    assert t[0].domain == problem["domain"] and t[0].metrics.success


def test_domains_the_port_lacks_name_their_item():
    """Every domain of the JAX table resolves in the port, chartqa and
    vlm_bandit among them since the VLM path was ported (they used to raise,
    naming their ROADMAP item); an unknown one raises."""
    with pytest.raises(KeyError, match="No rollout generator"):
        t_registry.resolve_domain_rollout("nope")
    for domain in ("tir", "coding", "deep_research", "miniwob", "chartqa", "vlm_bandit"):
        fn = t_registry.resolve_domain_rollout(domain)
        assert fn.__module__.startswith("pipelinerl_tpu_torch.domains.")
        assert fn.__name__ == j_registry.resolve_domain_rollout(domain).__name__


def _results(types, spec):
    """RolloutResults of ``types`` from (success, [(output_tokens, finished,
    reward)]) per rollout; the metrics' reward is the texts' sum."""
    out = []
    for success, texts in spec:
        tts = [types.TrainingText(output_tokens=n, finished=f, reward=r) for n, f, r in texts]
        metrics = types.BaseMetrics(reward=sum(r for _, _, r in texts), success=success, no_error=True,
                                    no_answer=False)
        out.append(types.RolloutResult(training_texts=tts, metrics=metrics))
    return out


GROUPS = [
    # a group of 4: two solved inside the buffer, one failed inside it, one
    # cut at max_tokens unfinished (the full penalty stays)
    [(True, [(60, True, 0.25)]), (True, [(50, True, 1.0)]), (False, [(62, True, -1.2)]), (False, [(64, False, -2.0)])],
    # every rollout solved, one of them over two texts
    [(True, [(57, True, 0.9), (63, True, 0.3)]), (True, [(10, True, 1.0)])],
    # none solved; one reached max_tokens yet finished
    [(False, [(64, True, -1.5)]), (False, [(33, False, -1.0)])],
]


@pytest.mark.parametrize("overrides", [
    ["actor.difficulty_aware_penalty.enabled=true", "rewards.buffer_tokens=16"],
    ["actor.difficulty_aware_penalty.enabled=true", "actor.difficulty_aware_penalty.gamma=2.0",
     "actor.difficulty_aware_penalty.failure_scale=0.5", "rewards.buffer_tokens=16"],
    ["actor.difficulty_aware_penalty.enabled=true", "rewards.buffer_tokens=0"],
    ["rewards.buffer_tokens=16"],
])
@pytest.mark.parametrize("group", GROUPS)
def test_difficulty_aware_penalty_equals_jax(overrides, group):
    j_cfg, t_cfg = config_pair("math", ["llm.parameters.max_tokens=64", *overrides])
    j_res, t_res = _results(j_types, group), _results(t_types, group)
    j_actor.ActorLoop._apply_difficulty_aware_penalty(SimpleNamespace(cfg=j_cfg, is_training=True), j_res)
    t_actor.ActorLoop._apply_difficulty_aware_penalty(SimpleNamespace(cfg=t_cfg, is_training=True), t_res)
    for jr, tr in zip(j_res, t_res):
        assert tr.metrics.reward == jr.metrics.reward
        assert [t.reward for t in tr.training_texts] == [t.reward for t in jr.training_texts]
    if group is GROUPS[0]:  # the rollout cut at max_tokens keeps its full penalty
        assert t_res[3].training_texts[0].reward == -2.0
        assert (t_res[0].metrics.reward != 0.25) == ("rewards.buffer_tokens=16" in overrides and len(overrides) > 1)
