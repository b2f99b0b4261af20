"""Continuous-batching engine (slab and paged KV layouts) and the in-process client."""

from .engine import EngineConfig, GenRequest, GenResult, InferenceEngine, SamplingParams

__all__ = ["EngineConfig", "GenRequest", "GenResult", "InferenceEngine", "SamplingParams"]
