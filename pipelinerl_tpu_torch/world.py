"""WorldMap: the jobs of a ``launch_mode=processes`` deployment.

Port of the JAX package's ``world.py`` for one host. Two layouts:

- ``world.trainer_procs=0`` (the default): one ``device`` job per replica,
  engine, HTTP server and trainer in one CUDA process, weight updates
  swapped in process;
- ``world.trainer_procs=1``: ``engine`` jobs serve rollouts and take weight
  pushes over HTTP (PWT3) from one ``trainer`` job, each its own CUDA
  process (two contexts on one card).

A ``ref_engine`` job (frozen weights, the KL reference policy) joins when
``world.ref_engine`` says so ("auto": when ``finetune.rl.kl_coef`` != 0),
and the ``actor`` and ``preprocessor`` jobs run on the host only.
``to_config()`` lists the jobs as the JAX package lists them.

Refused, each naming its ROADMAP Queue 1 item: more than one host (ssh
placement and the stream hub, item 5), ``world.stream_hub`` (item 5),
environment servers (item 5) and ``trainer_procs`` > 1 (item 8).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .config import Config


@dataclass
class Job:
    kind: str  # "device" | "engine" | "ref_engine" | "trainer" | "actor" | "preprocessor"
    replica_idx: int = 0
    hostname: str = "127.0.0.1"
    port: int | None = None
    # extra per-job settings handed to the child as cfg.me
    extra: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "replica_idx": self.replica_idx, "hostname": self.hostname, "port": self.port,
                **self.extra}


def refuse_unported(cfg: Config) -> None:
    """Raise for the deployments the port does not run yet."""
    world = cfg.get("world", Config({}))
    problems = []
    if len(list(world.get("hosts", ["127.0.0.1"]))) > 1:
        problems.append("world.hosts with more than one host (ssh placement and the stream hub) "
                        "is not ported yet (ROADMAP Queue 1, item 5)")
    hub = world.get("stream_hub", "auto")
    if hub != "auto" and bool(hub):
        problems.append("world.stream_hub is not ported yet (ROADMAP Queue 1, item 5)")
    if int(world.get("trainer_procs", 0)) > 1:
        problems.append("world.trainer_procs > 1 (a sharded trainer world) is not ported yet (ROADMAP Queue 1, item 8)")
    if cfg.get("environment") or cfg.get("environment_class"):
        problems.append("environment servers (run_environment) are not ported yet (ROADMAP Queue 1, item 5)")
    if problems:
        raise NotImplementedError("; ".join(problems))


class WorldMap:
    def __init__(self, cfg: Config):
        refuse_unported(cfg)
        world = cfg.get("world", Config({}))
        self.hosts: list[str] = list(world.get("hosts", ["127.0.0.1"]))
        self.replicas = int(world.get("replicas", 1))
        self.trainer_procs = int(world.get("trainer_procs", 0))
        engine_port = int(world.get("engine_start_port", 8080))
        self.coordinator_port = int(world.get("coordinator_port", 7199))
        host = self.hosts[0]

        self.jobs: list[Job] = []
        # the reference policy of the KL penalty: "auto" provisions it iff
        # kl_coef != 0
        ref_setting = world.get("ref_engine", "auto")
        kl_coef = float(cfg.select("finetune.rl.kl_coef", 0.0) or 0.0)
        self.needs_ref_engine = kl_coef != 0.0 if ref_setting == "auto" else bool(ref_setting)
        self.ref_engine_port = int(world.get("ref_engine_port", engine_port + 500))
        if self.trainer_procs > 0:
            for i in range(self.replicas):
                self.jobs.append(Job(kind="engine", replica_idx=i, hostname=host, port=engine_port + i))
            self.jobs.append(Job(kind="trainer", replica_idx=0, hostname=host, extra={
                "process_id": 0, "num_processes": 1, "coordinator": f"{host}:{self.coordinator_port}",
            }))
        else:
            # one device job per replica: engine, server and trainer
            for i in range(self.replicas):
                self.jobs.append(Job(kind="device", replica_idx=i, hostname=host, port=engine_port + i))
        if self.needs_ref_engine:
            self.jobs.append(Job(kind="ref_engine", replica_idx=0, hostname=host, port=self.ref_engine_port,
                                 extra={"frozen": True}))
        n_actors = int(cfg.actor.get("replicas", 1)) if "actor" in cfg else 1
        for i in range(n_actors):
            self.jobs.append(Job(kind="actor", replica_idx=i, hostname=host))
        self.jobs.append(Job(kind="preprocessor", replica_idx=0, hostname=host))

    @property
    def llm_urls(self) -> list[str]:
        return [f"http://{j.hostname}:{j.port}" for j in self.jobs if j.kind in ("device", "engine") and j.port]

    @property
    def ref_llm_urls(self) -> list[str]:
        return [f"http://{j.hostname}:{j.port}" for j in self.jobs if j.kind == "ref_engine" and j.port]

    def jobs_of(self, kind: str) -> list[Job]:
        return [j for j in self.jobs if j.kind == kind]

    def to_config(self) -> list[dict]:
        return [j.to_dict() for j in self.jobs]
