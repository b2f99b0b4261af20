"""WorldMap: the jobs of a ``launch_mode=processes`` deployment and where
they run.

Port of the JAX package's ``world.py``. ``world.hosts`` lists the hosts
(the first is the head, where the launcher runs; a host other than
``127.0.0.1`` and ``localhost`` is reached over ssh). Two layouts:

- ``world.trainer_procs=0`` (the default): one ``device`` job per replica,
  engine, HTTP server and trainer in one CUDA process, weight updates
  swapped in process;
- ``world.trainer_procs`` >= 1: ``engine`` jobs serve rollouts and take
  weight pushes over HTTP (PWT3) from the ``trainer`` jobs; with
  ``world.actor_fraction`` and ``world.finetune_fraction`` set over more
  than one host, the engines take the first hosts and the trainers the
  rest. More than one trainer job is a trainer world
  (``parallel/multihost.py``): each carries ``process_id``,
  ``num_processes`` and ``coordinator`` (the head host's
  ``world.coordinator_port``). The port runs one rank per device, so a
  ``parallel`` product dp*cp*tp above 1 is a world of dp*cp*tp trainer jobs
  whatever ``trainer_procs`` says (``trainer_ranks``), and the trainer
  partitions are one per dp rank (``num_trainers``): cp and tp peers read
  the same one.
- ``engine.tp`` or ``engine.pp`` above 1: each engine (and the reference
  engine) is ``engine.tp * engine.pp`` rank jobs on its host: rank 0 is the
  ``engine`` job with its port (the only HTTP URL), ranks above 0 are
  ``engine_rank`` jobs with no port; each carries ``tp_rank`` (its rank in
  the engine's world, ``stage·tp + tp rank``), ``tp_size``,
  ``tp_coordinator`` (the host's ``world.engine_tp_port`` plus the engine's
  index) and, at pp above 1, ``pp_size``. Such a config runs the split
  layout (one trainer job at least).

Beside them: a ``stream_hub`` on the head host when ``world.stream_hub``
says so (``"auto"``: more than one host), through which every topic then
rides; a ``ref_engine`` (frozen weights, the KL reference policy) when
``world.ref_engine`` says so (``"auto"``: ``finetune.rl.kl_coef`` != 0);
``world.env_replicas`` ``environment`` jobs when ``environment`` or
``environment_class`` is set; and the host-only ``actor`` and
``preprocessor`` jobs, spread round-robin over the hosts. ``to_config()``
lists the jobs as the JAX package lists them. ``parallel.pp`` is not read,
as the JAX package reads it nowhere.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .config import Config

LOCAL_HOSTS = ("127.0.0.1", "localhost")


@dataclass
class Job:
    kind: str  # "device" | "engine" | "engine_rank" | "ref_engine" | "trainer" | "stream_hub" | "actor" | ...
    replica_idx: int = 0
    hostname: str = "127.0.0.1"
    port: int | None = None
    # extra per-job settings handed to the child as cfg.me
    extra: dict = field(default_factory=dict)

    @property
    def is_local(self) -> bool:
        return self.hostname in LOCAL_HOSTS

    def to_dict(self) -> dict:
        return {"kind": self.kind, "replica_idx": self.replica_idx, "hostname": self.hostname, "port": self.port,
                **self.extra}


def parallel_product(cfg: Config) -> tuple[int, int, int]:
    """(dp, cp, tp) of the ``parallel`` node (1, 1, 1 when absent)."""
    par = cfg.get("parallel") or Config({})
    return int(par.get("dp", 1)), int(par.get("cp", 1)), int(par.get("tp", 1))


def engine_tp(cfg: Config) -> int:
    return int(cfg.select("engine.tp", 1) or 1)


def engine_pp(cfg: Config) -> int:
    return int(cfg.select("engine.pp", 1) or 1)


def engine_ranks(cfg: Config) -> int:
    """The rank processes of one engine: ``engine.tp * engine.pp``."""
    return engine_tp(cfg) * engine_pp(cfg)


def trainer_ranks(cfg: Config) -> int:
    """The trainer jobs: dp*cp*tp when that product is above 1 (one rank per
    device), else ``world.trainer_procs`` (at least one beside an engine
    of many ranks)."""
    procs = int(cfg.select("world.trainer_procs", 0) or 0)
    dp, cp, tp = parallel_product(cfg)
    if dp * cp * tp > 1:
        if procs > 1 and procs != dp * cp * tp:
            raise ValueError(f"world.trainer_procs={procs} but parallel dp*cp*tp={dp * cp * tp}: "
                             "the port runs one trainer rank per device")
        return dp * cp * tp
    return max(procs, 1) if engine_ranks(cfg) > 1 else procs


def _fraction_split(n_hosts: int, actor_fraction: float, finetune_fraction: float) -> int:
    """Hosts for the engines when the fractions are set, in [1, n_hosts - 1]."""
    total = actor_fraction + finetune_fraction
    if total <= 0:
        return max(1, n_hosts // 2)
    k = round(n_hosts * actor_fraction / total)
    return min(max(k, 1), n_hosts - 1)


class WorldMap:
    def __init__(self, cfg: Config):
        world = cfg.get("world", Config({}))
        self.hosts: list[str] = list(world.get("hosts", ["127.0.0.1"]))
        self.replicas = int(world.get("replicas", 1))
        self.trainer_procs = trainer_ranks(cfg)
        _, cp, tp = parallel_product(cfg)
        self.trainer_group = cp * tp  # trainer ranks that read one partition
        self.engine_tp = engine_tp(cfg)
        self.engine_pp = engine_pp(cfg)
        self.actor_fraction = float(world.get("actor_fraction", 0) or 0)
        self.finetune_fraction = float(world.get("finetune_fraction", 0) or 0)
        self.env_replicas = int(world.get("env_replicas", 1))
        engine_port = int(world.get("engine_start_port", 8080))
        env_port = int(world.get("environment_start_port", 7777))
        self.stream_hub_port = int(world.get("stream_hub_port", 7099))
        self.coordinator_port = int(world.get("coordinator_port", 7199))
        engine_tp_port = int(world.get("engine_tp_port", 7299))
        hub_setting = world.get("stream_hub", "auto")
        self.use_stream_hub = len(self.hosts) > 1 if hub_setting == "auto" else bool(hub_setting)

        def host(i: int) -> str:
            return self.hosts[i % len(self.hosts)]

        self.jobs: list[Job] = []
        if self.use_stream_hub:
            self.jobs.append(Job(kind="stream_hub", hostname=self.hosts[0], port=self.stream_hub_port))
        ref_setting = world.get("ref_engine", "auto")
        kl_coef = float(cfg.select("finetune.rl.kl_coef", 0.0) or 0.0)
        self.needs_ref_engine = kl_coef != 0.0 if ref_setting == "auto" else bool(ref_setting)
        self.ref_engine_port = int(world.get("ref_engine_port", engine_port + 500))
        if self.trainer_procs > 0:
            n = len(self.hosts)
            if (self.actor_fraction > 0 or self.finetune_fraction > 0) and n > 1:
                n_engine_hosts = _fraction_split(n, self.actor_fraction, self.finetune_fraction)
                engine_host = lambda i: self.hosts[i % n_engine_hosts]  # noqa: E731
                trainer_host = lambda i: self.hosts[n_engine_hosts + (i % (n - n_engine_hosts))]  # noqa: E731
            else:
                engine_host = host
                trainer_host = lambda i: self.hosts[n - 1 - (i % n)]  # noqa: E731
            for i in range(self.replicas):
                self._add_engine("engine", i, engine_host(i), engine_port + i, engine_tp_port + i)
            coordinator = f"{self.hosts[0]}:{self.coordinator_port}"
            for i in range(self.trainer_procs):
                self.jobs.append(Job(kind="trainer", replica_idx=i, hostname=trainer_host(i), extra={
                    "process_id": i, "num_processes": self.trainer_procs, "coordinator": coordinator,
                }))
        else:
            # one device job per replica: engine, server and trainer
            for i in range(self.replicas):
                self.jobs.append(Job(kind="device", replica_idx=i, hostname=host(i), port=engine_port + i))
        if self.needs_ref_engine:
            self._add_engine("ref_engine", 0, host(self.replicas), self.ref_engine_port,
                             engine_tp_port + self.replicas, frozen=True)
        if cfg.get("environment") or cfg.get("environment_class"):
            for i in range(self.env_replicas):
                self.jobs.append(Job(kind="environment", replica_idx=i, hostname=host(i), port=env_port + i))
        n_actors = int(cfg.actor.get("replicas", 1)) if "actor" in cfg else 1
        for i in range(n_actors):
            self.jobs.append(Job(kind="actor", replica_idx=i, hostname=host(i)))
        self.jobs.append(Job(kind="preprocessor", replica_idx=0, hostname=self.hosts[0]))

    def _add_engine(self, kind: str, replica: int, hostname: str, port: int, tp_port: int, **extra) -> None:
        """An engine job, and at ``engine.tp * engine.pp`` above 1 its rank
        jobs on the same host (``engine_rank``, no port)."""
        n = self.engine_tp * self.engine_pp
        if n == 1:
            self.jobs.append(Job(kind=kind, replica_idx=replica, hostname=hostname, port=port, extra=extra))
            return
        ranks = {"tp_size": self.engine_tp, "tp_coordinator": f"{hostname}:{tp_port}",
                 **({"pp_size": self.engine_pp} if self.engine_pp > 1 else {})}
        self.jobs.append(Job(kind=kind, replica_idx=replica, hostname=hostname, port=port,
                             extra={**extra, **ranks, "tp_rank": 0}))
        base = sum(1 for j in self.jobs if j.kind == "engine_rank")
        for r in range(1, n):
            self.jobs.append(Job(kind="engine_rank", replica_idx=base + r - 1, hostname=hostname,
                                 extra={**extra, **ranks, "tp_rank": r, "engine": f"{kind}_{replica}"}))

    @property
    def llm_urls(self) -> list[str]:
        return [f"http://{j.hostname}:{j.port}" for j in self.jobs if j.kind in ("device", "engine") and j.port]

    @property
    def ref_llm_urls(self) -> list[str]:
        return [f"http://{j.hostname}:{j.port}" for j in self.jobs if j.kind == "ref_engine" and j.port]

    @property
    def stream_hub_addr(self) -> str | None:
        return next((f"{j.hostname}:{j.port}" for j in self.jobs if j.kind == "stream_hub"), None)

    @property
    def num_trainers(self) -> int:
        """Trainer stream partitions: one per dp rank of the trainer world
        (its processes over cp and tp), or per device job."""
        return self.trainer_procs // self.trainer_group if self.trainer_procs > 0 else self.replicas

    @property
    def environment_servers(self) -> list[dict]:
        return [{"hostname": j.hostname, "port": j.port} for j in self.jobs if j.kind == "environment"]

    def jobs_of(self, kind: str) -> list[Job]:
        return [j for j in self.jobs if j.kind == kind]

    def to_config(self) -> list[dict]:
        return [j.to_dict() for j in self.jobs]
