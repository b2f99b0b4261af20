"""LLM client data model and the in-process client.

Port of the JAX package's ``inference/client.py`` (the engine loads only
when an ``InProcessLLM`` makes a request, so the data model imports no
kernel): ``Prompt(messages)`` in, ``LLMCall`` out with exact token ids and
per-token sampler logprobs, and ``make_training_text`` building the
token-exact RL sample from one call. A prompt with image parts goes through
the client's visual processor (``inference/processor.py``), whose features
ride with the call into the sample. Plain dataclasses take the place of the
pydantic models.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

from ..types import MASKED_TOKEN_ID, TrainingText

if TYPE_CHECKING:
    from .engine import GenResult, InferenceEngine, SamplingParams


@dataclass
class Prompt:
    messages: list[dict] = field(default_factory=list)
    tools: list[dict] | None = None
    id: str = field(default_factory=lambda: str(uuid.uuid4()))

    def has_images(self) -> bool:
        """Whether any message's content is a parts list with an image part."""
        return any(
            isinstance(m.get("content"), list) and any(p.get("type") in ("image", "image_url") for p in m["content"])
            for m in self.messages
        )


@dataclass
class LLMMessage:
    role: str = "assistant"
    content: str | None = None
    tool_calls: list[dict] | None = None


@dataclass
class LLMCall:
    """One completed generation with everything RL needs."""

    prompt: Prompt
    output: LLMMessage
    prompt_token_ids: list[int]
    output_token_ids: list[int]
    logprobs: list[float]
    finish_reason: str
    model_version_start: int = 0
    model_version_end: int = 0
    latency: float = 0.0
    # VLM: {"pixel_values", "image_grid_thw"} as the processor extracted them
    visual: dict | None = None

    @property
    def prompt_length_tokens(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def output_length_tokens(self) -> int:
        return len(self.output_token_ids)


class BaseLLM:
    """Interface of the clients: a tokenizer, sampling defaults and
    ``agenerate``."""

    tokenizer: Any
    parameters: dict

    async def agenerate(self, prompt: Prompt, **overrides) -> LLMCall:
        raise NotImplementedError


class InProcessLLM(BaseLLM):
    """Client bound directly to a local ``InferenceEngine``.

    ``parameters`` holds the sampling defaults (max_tokens, temperature,
    top_p, top_k, stop_token_ids); ``agenerate`` overrides them per call."""

    def __init__(
        self,
        engine: InferenceEngine,
        tokenizer,  # eos_token_id, apply_chat_template, decode (HF-compatible)
        parameters: dict | None = None,
        chat_template_kwargs: dict | None = None,
        processor=None,  # inference.processor.VisualProcessorLike, VLM only
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.parameters = dict(parameters or {})
        self.chat_template_kwargs = dict(chat_template_kwargs or {})
        self.processor = processor

    def make_sampling_params(self, **overrides) -> SamplingParams:
        from .engine import SamplingParams

        p = {**self.parameters, **overrides}
        return SamplingParams(
            temperature=float(p.get("temperature", 1.0)),
            top_p=float(p.get("top_p", 1.0)),
            top_k=int(p.get("top_k", 0) or 0),
            max_tokens=int(p.get("max_tokens", 256)),
            stop_token_ids=tuple(p.get("stop_token_ids", ())),
        )

    def prompt_token_ids(self, prompt: Prompt) -> list[int]:
        kwargs = dict(self.chat_template_kwargs)
        if prompt.tools:
            kwargs["tools"] = prompt.tools
        return list(
            self.tokenizer.apply_chat_template(prompt.messages, add_generation_prompt=True, **kwargs)
        )

    async def agenerate(self, prompt: Prompt, session: Any = None, **overrides) -> LLMCall:
        from .engine import GenRequest

        start = time.monotonic()
        visual = None
        if prompt.has_images():
            if self.processor is None:
                raise ValueError("prompt contains images but the client has no processor")
            prompt_ids, visual = self.processor(prompt.messages, tools=prompt.tools)
        else:
            prompt_ids = self.prompt_token_ids(prompt)
        request = GenRequest(
            prompt_ids=prompt_ids,
            params=self.make_sampling_params(**overrides),
            request_id=prompt.id,
            visual=visual,
        )
        try:
            result: GenResult = await asyncio.wrap_future(self.engine.submit(request))
        except asyncio.CancelledError:
            # a cancelled rollout frees its decode slot at once
            self.engine.abort(request.request_id)
            raise
        content = self.tokenizer.decode(result.token_ids, skip_special_tokens=True)
        return LLMCall(
            prompt=prompt,
            output=LLMMessage(role="assistant", content=content),
            prompt_token_ids=prompt_ids,
            output_token_ids=list(result.token_ids),
            logprobs=list(result.logprobs),
            finish_reason=result.finish_reason,
            model_version_start=result.model_version_start,
            model_version_end=result.model_version_end,
            latency=time.monotonic() - start,
            visual=visual,
        )


def make_training_text(llm: BaseLLM, llm_call: LLMCall) -> TrainingText:
    """The token-exact RL sample of one generation: input_ids are the
    chat-template prompt ids plus the sampled ids, the prompt masked out of
    the labels."""
    prompt_ids = llm_call.prompt_token_ids
    completion_ids = llm_call.output_token_ids
    input_ids = prompt_ids + completion_ids
    output_text = llm.tokenizer.decode(completion_ids, skip_special_tokens=False)
    visual_features = None
    if llm_call.visual is not None:
        visual_features = {k: _tolist(llm_call.visual[k]) for k in ("pixel_values", "image_grid_thw")}
    return TrainingText(
        text=llm.tokenizer.decode(input_ids, skip_special_tokens=False),
        n_predicted=len(output_text),
        input_ids=input_ids,
        labels=[MASKED_TOKEN_ID] * len(prompt_ids) + completion_ids,
        logprobs=list(llm_call.logprobs),
        finished=llm_call.finish_reason != "length",
        finish_reason=llm_call.finish_reason,
        prompt_tokens=len(prompt_ids),
        output_tokens=len(completion_ids),
        visual_features=visual_features,
        # the version the engine generated under (a sample that spans an
        # in-flight update keeps its start)
        metadata={"model_version": llm_call.model_version_start},
    )


def _tolist(x):
    return x.tolist() if hasattr(x, "tolist") else x


async def llm_async_generate(llm: BaseLLM, prompt: Prompt, session: Any = None, **overrides) -> LLMCall:
    """The domains' name for ``llm.agenerate``."""
    return await llm.agenerate(prompt, session=session, **overrides)
