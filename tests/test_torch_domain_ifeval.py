"""The port's ifeval domain against the JAX package's: every ``CHECKERS`` id
on its JAX test case and on more responses, the synthetic set and local
files item for item, and the partial-credit rollout under one scripted LLM
on the toy and the fixture tokenizers."""

import json

import pytest

from pipelinerl_tpu.domains.ifeval import checkers as j_checkers
from pipelinerl_tpu.domains.ifeval import dataset as j_dataset
from pipelinerl_tpu.domains.ifeval import rollouts as j_rollouts
from pipelinerl_tpu_torch.domains.ifeval import checkers as t_checkers
from pipelinerl_tpu_torch.domains.ifeval import dataset as t_dataset
from pipelinerl_tpu_torch.domains.ifeval import rollouts as t_rollouts
from tests import test_ifeval_domain as j_tests
from tests.test_torch_domain_math import config_pair, outcome, scripted_rollouts
from tests.test_torch_domains import assert_same_rollout

# the JAX test's (id, kwargs, good, bad) cases
CASES = {args[0]: args[1:] for args in j_tests.test_checker.pytestmark[0].args[1]}
EXTRA = ["", "   ", "lower case only", "UPPER CASE ONLY", "a, b, c", "P.S. done", "- a\n- b\n* c", "<<T>>",
         '```json\n{"a": 1}\n```', "Section 1 x Section 2 y", "first\n\nsecond\n\nthird", "a\n***\nb\n***\nc",
         "My answer is maybe.", '"q"', "*hi* *there*", "water water water, sky", "Say hi", "one. two! three?"]


def test_every_checker_has_a_case():
    assert sorted(t_checkers.CHECKERS) == sorted(j_checkers.CHECKERS)
    missing = set(t_checkers.CHECKERS) - set(CASES)
    # two ids have no JAX test case: they get kwargs here
    assert missing == {"length_constraints:nth_paragraph_first_word", "detectable_format:multiple_sections"}


@pytest.mark.parametrize("iid", sorted(j_checkers.CHECKERS))
def test_checker_equals_jax(iid):
    kwargs, good, bad = CASES.get(iid, ({}, "", ""))
    if iid == "length_constraints:nth_paragraph_first_word":
        kwargs, good, bad = {"num_paragraphs": 2, "nth_paragraph": 2, "first_word": "second"}, "a\n\nsecond b", "a"
    elif iid == "detectable_format:multiple_sections":
        kwargs, good, bad = {"section_spliter": "Section", "num_sections": 2}, "Section 1 a Section 2 b", "Section 1"
    assert t_checkers.check_instruction(good, iid, kwargs) is True
    assert t_checkers.check_instruction(bad, iid, kwargs) is False
    for response in [good, bad, *EXTRA]:
        assert outcome(t_checkers.check_instruction, response, iid, kwargs) == \
            outcome(j_checkers.check_instruction, response, iid, kwargs), (iid, response)
    with pytest.raises(KeyError):
        t_checkers.check_instruction("x", "not:a_checker", {})


def test_datasets_equal_jax(tmp_path):
    assert t_dataset.load_datasets(["synthetic_ifeval"]) == j_dataset.load_datasets(["synthetic_ifeval"])
    rows = [{"prompt": "Write in lowercase.", "instruction_id_list": ["change_case:english_lowercase"]},
            {"prompt": "No ids"}, {"task": "t", "instruction_id_list": ["punctuation:no_comma"], "kwargs": [{}]}]
    path = tmp_path / "mine.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    assert t_dataset.load_datasets([str(path)]) == j_dataset.load_datasets([str(path)])
    with pytest.raises(ValueError, match="not in the repository"):
        t_dataset.load_datasets(["ifeval"])


@pytest.mark.parametrize("kind", ["toy", "fixture"])
@pytest.mark.parametrize("index,reply", [
    (0, "winter is calm and bright"),  # lowercase: followed
    (0, "Winter Is Calm"),
    (4, "water " * 31),  # both of two instructions
    (4, "rivers are long"),  # neither
    (4, "water flows"),  # one of two: partial credit 0.5
])
def test_ifeval_rollout_equals_jax(kind, index, reply):
    templates = {}
    for p in t_dataset.load_datasets(["synthetic_ifeval"]):
        templates.setdefault(tuple(p["instruction_id_list"]), p)
    problem = list(templates.values())[index]
    j, t = scripted_rollouts(j_rollouts.generate_ifeval_rollout, t_rollouts.generate_ifeval_rollout,
                             config_pair("ifeval", ["model_path=toy"]), problem, [reply], kind=kind)
    assert_same_rollout(j, t)
    m = t[0].metrics
    assert m.reward == m.instructions_followed / m.instructions_total


def test_partial_credit_is_half_on_one_of_two():
    problem = {"task": "t", "instruction_id_list": ["length_constraints:number_words", "keywords:existence"],
               "kwargs": [{"num_words": 30, "relation": "at least"}, {"keywords": ["water"]}], "dataset": "d",
               "domain": "ifeval"}
    _, t = scripted_rollouts(j_rollouts.generate_ifeval_rollout, t_rollouts.generate_ifeval_rollout,
                             config_pair("ifeval", ["model_path=toy"]), problem, ["water flows"])
    assert t[0].metrics.reward == 0.5 and not t[0].metrics.success
