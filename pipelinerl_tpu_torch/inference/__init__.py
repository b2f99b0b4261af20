"""Continuous-batching engine (slab and paged KV layouts), its clients and
its HTTP server.

The engine's names load on first use, so that host-only stages (the actor
and the preprocessor, which reach the engine over HTTP) import no model
and no kernel.
"""

__all__ = ["EngineConfig", "GenRequest", "GenResult", "InferenceEngine", "SamplingParams"]


def __getattr__(name: str):
    if name in __all__:
        from . import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
