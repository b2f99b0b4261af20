"""The environment servers a rollout reaches.

``cfg.environment`` lists them (the launcher sets it from the world map's
``environment`` jobs). ``ActorLoop`` opens one client session for them and
hands it to every rollout; the math, logic, miniwob and deep_research
rollouts then grade or step on the servers. Where ``cfg.environment`` names
no server, they run in process.
"""

from __future__ import annotations

from typing import Any


def environment_servers(cfg: Any) -> list[tuple[str, int]]:
    """(host, port) of each entry of ``cfg.environment`` that names a port."""
    env = cfg.get("environment") if hasattr(cfg, "get") else None
    if not env:
        return []
    servers = []
    for entry in env if isinstance(env, list) else [env]:
        host = entry.get("hostname", "127.0.0.1") if hasattr(entry, "get") else "127.0.0.1"
        port = entry.get("port") if hasattr(entry, "get") else None
        if port:
            servers.append((host, int(port)))
    return servers


def rollout_servers(cfg: Any, session: Any) -> list[tuple[str, int]]:
    """The servers a rollout uses: none where ``cfg.environment`` names none
    (the rollout runs in process), else all of them over ``session``. A
    rollout handed no session while servers are named raises: running in
    process would leave the servers unused, unseen (the JAX package's actor
    passes no session, and its rollouts do just that)."""
    servers = environment_servers(cfg)
    if servers and session is None:
        raise ValueError(f"cfg.environment names {len(servers)} environment server(s) but the rollout got no "
                         "client session (ActorLoop opens one for them)")
    return servers
