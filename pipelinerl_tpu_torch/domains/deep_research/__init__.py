"""Deep-research domain: a multi-step agent searches and reads a
deterministic document corpus, in process or on ``ResearchEnvironment``
servers, and submits an answer, one TrainingText per LLM call."""

from .environment import ResearchCorpus, build_corpus, load_problems  # noqa: F401
from .rollouts import generate_research_rollout  # noqa: F401
