"""The port's VLM domains against the JAX package's: ``vlm_bandit`` (its
problems, images and rewards through a scripted LLM with the toy visual
processor), and ``chartqa`` (relaxed-correctness evaluation on a table of
answers; the rollout with a pre-built feature message through a scripted
LLM, under the preset's system prompt, task template and rewards; the hub
split names raise). Each rollout's prompt ids, visual features, training
text and metrics equal JAX's."""

import asyncio
import copy

import numpy as np
import pytest

from pipelinerl_tpu.domains import vlm_bandit as j_bandit
from pipelinerl_tpu.domains.chartqa import chartqa as j_chartqa
from pipelinerl_tpu.domains.chartqa import evaluation as j_eval
from pipelinerl_tpu.inference import engine as j_engine
from pipelinerl_tpu.inference.client import InProcessLLM as JInProcessLLM
from pipelinerl_tpu.models.toy_tokenizer import ToyTokenizer as JToyTokenizer
from pipelinerl_tpu.models.toy_tokenizer import ToyVisualProcessor as JToyVisualProcessor
from pipelinerl_tpu_torch.domains import vlm_bandit as t_bandit
from pipelinerl_tpu_torch.domains.chartqa import chartqa as t_chartqa
from pipelinerl_tpu_torch.domains.chartqa import evaluation as t_eval
from pipelinerl_tpu_torch.inference import engine as t_engine
from pipelinerl_tpu_torch.inference.client import InProcessLLM
from pipelinerl_tpu_torch.models.toy_tokenizer import IMAGE, ToyTokenizer, ToyVisualProcessor
from tests.test_torch_domain_math import ScriptedEngine, config_pair
from tests.test_torch_domains import TEXT_FIELDS


class RecordingEngine(ScriptedEngine):
    """The scripted engine, keeping each request's visual features too."""

    def submit(self, request):
        self.visuals = getattr(self, "visuals", []) + [request.visual]
        return super().submit(request)


def vlm_rollouts(j_fn, t_fn, cfgs, problem, reply_ids, finish="stop"):
    out = []
    for mod, llm_cls, tok, proc, fn, cfg in (
            (j_engine, JInProcessLLM, JToyTokenizer(), JToyVisualProcessor, j_fn, cfgs[0]),
            (t_engine, InProcessLLM, ToyTokenizer(), ToyVisualProcessor, t_fn, cfgs[1])):
        engine = RecordingEngine(mod, copy.deepcopy(reply_ids), finish)
        llm = llm_cls(engine, tok, {"max_tokens": 16}, processor=proc(tok, 2))
        out.append((asyncio.run(fn(cfg, llm, copy.deepcopy(problem), None)), engine))
    return out


def assert_same_vlm_rollout(j, t):
    (jr, je), (tr, te) = j, t
    assert te.prompts == je.prompts and IMAGE in te.prompts[0]
    for jv, tv in zip(je.visuals, te.visuals):
        assert sorted(tv) == sorted(jv)
        for k in jv:
            np.testing.assert_array_equal(np.asarray(tv[k]), np.asarray(jv[k]), err_msg=k)
    assert tr.metrics.model_dump() == jr.metrics.model_dump()
    assert (tr.domain, tr.dataset_name) == (jr.domain, jr.dataset_name)
    for ttext, jtext in zip(tr.training_texts, jr.training_texts):
        assert {f: getattr(ttext, f) for f in TEXT_FIELDS} == {f: getattr(jtext, f) for f in TEXT_FIELDS}
        assert ttext.visual_features == jtext.visual_features


def test_vlm_bandit_problems_and_images_equal_jax():
    names = ["train", "test"]
    assert t_bandit.load_problems(names) == j_bandit.load_problems(names)
    for sign in (1, -1):
        t_img, j_img = t_bandit.make_image(sign, 12), j_bandit.make_image(sign, 12)
        np.testing.assert_array_equal(t_img["pixel_values"], j_img["pixel_values"])
        assert t_img["image_grid_thw"] == j_img["image_grid_thw"]


@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("reply", [[40], [200, 5], [257], [130, 100, 257]])
def test_vlm_bandit_rollout_equals_jax(sign, reply):
    """A low first byte, a high one, a special token first (the -0.5
    reward), and a high byte then EOS; for each class of image."""
    problem = next(p for p in j_bandit.load_problems(["train"]) if p["sign"] == sign)
    cfgs = config_pair("vlm_bandit_cpu")
    j, t = vlm_rollouts(j_bandit.generate_vlm_bandit_rollout, t_bandit.generate_vlm_bandit_rollout, cfgs, problem,
                        [reply])
    assert_same_vlm_rollout(j, t)
    assert t[0].metrics.reward == j[0].metrics.reward


TEMPLATE = 'actor.task_template="Question: {question} (answer in a box)"'


EVAL_TABLE = [
    (r"The chart shows \boxed{42}", "42"), (r"\boxed{41}", "42"), (r"\boxed{43.9}", "42"), (r"\boxed{44.5}", "42"),
    ("The answer is 12%.", "0.12"), ("answer: Yes", "yes"), ("Final answer is blue", "Blue"), ("blue", "red"),
    ("", "3"), ("Let me think\nabout it for a very long time without an answer at all", "3"),
    (r"\boxed{1,200}", "1200"), (r"\boxed{0}", "0"), (r"a \boxed{2} then \boxed{3}", "3"), (r"\boxed{}", "x"),
    ("answer: 1e400", "5"),
]


@pytest.mark.parametrize("pred,gold", EVAL_TABLE)
def test_chartqa_evaluation_equals_jax(pred, gold):
    assert t_eval.extract_answer(pred) == j_eval.extract_answer(pred)
    assert t_eval.evaluate_answer(pred, gold) == j_eval.evaluate_answer(pred, gold)
    answer = t_eval.extract_answer(pred)
    if answer is not None:
        assert t_eval.relaxed_correctness(gold, answer) == j_eval.relaxed_correctness(gold, answer)


@pytest.mark.parametrize("reply,finish", [(r"It is \boxed{42}", "stop"), (r"\boxed{7}", "stop"),
                                          ("no idea", "length"), ("", "stop")])
def test_chartqa_rollout_equals_jax(reply, finish):
    """The chartqa preset's system prompt over a pre-built message with a
    feature image, a scripted reply, the reward table and the length
    discount, in each package (with a task template that ``str.format``
    takes; the preset's own is the next test's)."""
    tok = ToyTokenizer()
    image = {"pixel_values": np.random.default_rng(0).normal(size=(24, 12)).astype(np.float32),
             "image_grid_thw": [1, 4, 6]}
    question = "What is the total?"
    problem = {"question": question, "answer": "42", "dataset": "chartqa_test", "domain": "chartqa",
               "message": {"role": "user", "content": [{"type": "image", "image": image},
                                                       {"type": "text", "text": question}]}}
    cfgs = config_pair("chartqa", ["model_path=toy", "+actor.discount_factor=0.99", TEMPLATE])
    reply_ids = tok.encode(reply) + ([tok.eos_token_id] if finish == "stop" else [])
    j, t = vlm_rollouts(j_chartqa.generate_chartqa_rollout, t_chartqa.generate_chartqa_rollout, cfgs, problem,
                        [reply_ids], finish)
    assert_same_vlm_rollout(j, t)
    # the port's feature route ("image" in the problem) builds the message
    # the task template gives
    own = {k: v for k, v in problem.items() if k != "message"}
    own["image"] = image
    task = cfgs[1].actor.task_template.format(question=question, task=question)

    def port_rollout(prob):
        llm = InProcessLLM(RecordingEngine(t_engine, [list(reply_ids)], finish), tok, {"max_tokens": 16},
                           processor=ToyVisualProcessor(tok, 2))
        return asyncio.run(t_chartqa.generate_chartqa_rollout(cfgs[1], llm, prob, None))

    routed, built = port_rollout(own), port_rollout({**own, "message": t_chartqa.multimodal_message(image, task)})
    assert routed.training_texts[0].input_ids == built.training_texts[0].input_ids
    assert routed.metrics.model_dump() == built.metrics.model_dump()


def test_the_preset_task_template_renders_where_jax_raises():
    """The chartqa preset's template ends in a literal ``\\boxed{}``, which
    ``str.format`` takes for a positional field: the JAX rollout raises
    IndexError on every problem, the port renders the question into the
    named field and keeps the braces."""
    jcfg, tcfg = config_pair("chartqa", ["model_path=toy"])
    template = tcfg.actor.task_template
    assert template == jcfg.actor.task_template and template.endswith("\\boxed{}.")
    with pytest.raises(IndexError):
        template.format(task="q", question="q")
    rendered = t_chartqa.render_task(template, "What is 2+2?")
    assert rendered == template.replace("{question}", "What is 2+2?")
    assert t_chartqa.render_task("Q: {question}", "x") == "Q: {question}".format(question="x")
    problem = {"question": "How many?", "answer": "3", "image": {"pixel_values": np.zeros((16, 12), np.float32),
                                                                 "image_grid_thw": [1, 4, 4]}}
    tok = ToyTokenizer()
    llm = InProcessLLM(RecordingEngine(t_engine, [tok.encode(r"\boxed{3}") + [tok.eos_token_id]], "stop"), tok,
                       {"max_tokens": 16}, processor=ToyVisualProcessor(tok, 2))
    result = asyncio.run(t_chartqa.generate_chartqa_rollout(tcfg, llm, problem, None))
    assert result.metrics.success and "How many?" in result.training_texts[0].text
    jllm = JInProcessLLM(RecordingEngine(j_engine, [[1]], "stop"), JToyTokenizer(), {"max_tokens": 16},
                         processor=JToyVisualProcessor(JToyTokenizer(), 2))
    with pytest.raises(IndexError):
        asyncio.run(j_chartqa.generate_chartqa_rollout(jcfg, jllm, {**problem, "message": {}}, None))


@pytest.mark.parametrize("name", ["chartqa_train", "chartqa_test"])
def test_chartqa_hub_names_raise_naming_the_missing_files(name):
    with pytest.raises(ValueError, match="not in the repository"):
        t_chartqa.load_datasets([name])
