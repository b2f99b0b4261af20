"""Stage entrypoints of ``launch_mode=processes``.

Each reads the config that ``launch.run_processes`` saved as JSON, with the
``+me.<key>=<value>`` overrides it passes, and runs one stage:
``run_device`` (engine, server and trainer in one CUDA process),
``run_engine`` (engine and server; ``me.frozen`` for the KL reference),
``run_trainer`` (pushes weights over HTTP), and the host-only
``run_actor``, ``run_preprocess``, ``run_environment`` (a verifier or
environment server) and ``run_stream_hub`` (the TCP stream hub), which
import no model and no kernel.
"""
