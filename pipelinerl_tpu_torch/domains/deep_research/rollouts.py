"""Research rollout: a multi-step agent loop of ``<search>``, ``<read>`` and
``<answer>`` actions, one TrainingText per LLM call, and a verified
final-answer reward less a cost per extra step.

Port of the JAX package's ``domains/deep_research/rollouts.py``: the tools
reach ``ResearchEnvironment`` servers where ``cfg.environment`` names them,
and the in-process corpus otherwise.
"""

from __future__ import annotations

import json
import random
import re
import time
from dataclasses import dataclass
from typing import Any

from ...inference.client import BaseLLM, Prompt, llm_async_generate, make_training_text
from ...types import BaseMetrics, RolloutResult, rollout_has_overflow
from ..servers import rollout_servers
from .environment import ResearchCorpus, build_corpus

DOMAIN = "deep_research"

_SEARCH_RE = re.compile(r"<search>(.*?)</search>", re.DOTALL)
_READ_RE = re.compile(r"<read>(.*?)</read>", re.DOTALL)
_ANSWER_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)

SYSTEM_PROMPT = (
    "You are a research assistant with a document corpus. Each turn you may "
    "use ONE action:\n"
    "<search>keywords</search> — search for documents\n"
    "<read>doc_id</read> — read a full document\n"
    "<answer>final answer</answer> — submit your answer\n"
    "Use as few steps as possible."
)


@dataclass
class ResearchMetrics(BaseMetrics):
    num_searches: int = 0
    num_reads: int = 0
    num_steps: int = 0
    overflow: bool = False


class _Tools:
    """search and read on a random research server when ``cfg.environment``
    names servers, else over the in-process corpus of ``seed``."""

    def __init__(self, cfg: Any, session: Any, seed: int):
        self.servers = rollout_servers(cfg, session)
        self.session = session if self.servers else None
        self.seed = seed
        self.corpus: ResearchCorpus | None = build_corpus(seed=seed)[0] if self.session is None else None

    async def search(self, query: str) -> list[dict]:
        if self.session is None:
            return self.corpus.search(query)
        host, port = random.choice(self.servers)
        async with self.session.get(f"http://{host}:{port}/search", params={"q": query, "seed": self.seed}) as r:
            return (await r.json())["results"]

    async def read(self, doc_id: str) -> str | None:
        if self.session is None:
            return self.corpus.read(doc_id)
        host, port = random.choice(self.servers)
        async with self.session.get(f"http://{host}:{port}/read", params={"id": doc_id, "seed": self.seed}) as r:
            if r.status != 200:
                return None
            return (await r.json())["text"]


def _normalize(text: str) -> str:
    return re.sub(r"\s+", " ", text.strip().lower()).strip(" .\"'")


async def generate_research_rollout(cfg: Any, llm: BaseLLM, problem: dict, session: Any = None) -> RolloutResult:
    start = time.perf_counter()
    actor_cfg = cfg.actor if hasattr(cfg, "actor") else cfg
    system_prompt = actor_cfg.get("system_prompt") or SYSTEM_PROMPT
    task_template = actor_cfg.get("task_template", "{task}")
    max_loops = int(actor_cfg.get("max_loops", 8))

    messages = [
        {"role": "system", "content": system_prompt},
        {"role": "user", "content": task_template.format(task=problem["task"])},
    ]
    tools = _Tools(cfg, session, int(problem.get("corpus_seed", 0)))

    llm_calls = []
    final_answer: str | None = None
    num_searches = num_reads = 0

    for _step in range(max_loops):
        llm_call = await llm_async_generate(llm, Prompt(messages=list(messages)), session)
        llm_calls.append(llm_call)
        content = llm_call.output.content or ""
        messages.append({"role": "assistant", "content": content})

        if m := _ANSWER_RE.search(content):
            final_answer = m.group(1).strip()
            break
        if m := _SEARCH_RE.search(content):
            num_searches += 1
            results = await tools.search(m.group(1).strip())
            obs = json.dumps(results) if results else "No results."
            messages.append({"role": "user", "content": f"<results>{obs}</results>"})
            continue
        if m := _READ_RE.search(content):
            num_reads += 1
            text = await tools.read(m.group(1).strip())
            obs = text if text is not None else "Document not found."
            messages.append({"role": "user", "content": f"<document>{obs}</document>"})
            continue
        messages.append({"role": "user", "content": "Invalid action. Use <search>, <read>, or <answer>."})

    gold = _normalize(str(problem.get("answer", "")))
    success = final_answer is not None and (_normalize(final_answer) == gold or gold in _normalize(final_answer))
    step_cost = float(actor_cfg.get("step_cost", 0.05))
    reward = (1.0 if success else -0.5) - step_cost * max(0, len(llm_calls) - 1)
    if final_answer is None:
        reward = -1.0

    traces = [make_training_text(llm, call) for call in llm_calls]
    overflow = rollout_has_overflow(traces)
    for t in traces:
        t.reward = reward

    metrics = ResearchMetrics(
        reward=reward,
        success=success,
        no_error=True,
        no_answer=final_answer is None,
        num_searches=num_searches,
        num_reads=num_reads,
        num_steps=len(llm_calls),
        overflow=overflow,
    )
    return RolloutResult(training_texts=traces, metrics=metrics, latency=time.perf_counter() - start,
                         dataset_name=problem.get("dataset"), domain=DOMAIN)
