"""The port's WorldMap against the JAX package's: the same jobs
(``to_config()``), URLs, hub address, environment servers and trainer
partitions for the same world settings, on one host and over host lists
(round-robin placement, the stream hub, environment replicas, the
actor/finetune host split, a trainer world of two processes);
``parallel.pp`` above 1, which neither package reads."""

import pytest

from pipelinerl_tpu.config import compose as jax_compose
from pipelinerl_tpu.world import WorldMap as JWorldMap
from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.world import WorldMap

WORLDS = {
    "device": [],
    "device_two_replicas": ["world.replicas=2"],
    "split": ["+world.trainer_procs=1"],
    "split_two_engines": ["+world.trainer_procs=1", "world.replicas=2"],
    "kl_auto": ["finetune=ppo"],
    "kl_auto_split": ["finetune=ppo", "+world.trainer_procs=1"],
    "ref_forced": ["+world.ref_engine=true"],
    "ref_off_with_kl": ["finetune=ppo", "+world.ref_engine=false"],
    "ref_off": ["+world.ref_engine=false"],
    "ports": ["world.engine_start_port=9100", "+world.ref_engine=true", "+world.ref_engine_port=9900",
              "+world.trainer_procs=1", "+world.coordinator_port=7300"],
    "actors": ["+actor.replicas=2", "+world.trainer_procs=1"],
    "two_hosts": ["+world.hosts=[10.0.0.1,10.0.0.2]"],
    "three_hosts_replicas": ["+world.hosts=[10.0.0.1,10.0.0.2,10.0.0.3]", "world.replicas=2", "+actor.replicas=3"],
    "local_names": ["+world.hosts=[127.0.0.1,localhost]", "+environment_class=env.Server", "world.env_replicas=2"],
    "hub_forced_one_host": ["+world.stream_hub=true", "+world.stream_hub_port=7300"],
    "hub_off_two_hosts": ["+world.hosts=[10.0.0.1,10.0.0.2]", "+world.stream_hub=false"],
    "environment": ["+environment_class=env.Server", "world.env_replicas=3", "world.environment_start_port=9000"],
    "environment_listed": ["+environment=[{hostname: 10.0.0.9, port: 1}]"],
    "split_fractions": ["+world.hosts=[h0,h1,h2,h3]", "+world.trainer_procs=1", "world.actor_fraction=3",
                        "world.finetune_fraction=1", "world.replicas=3"],
    "split_no_fractions": ["+world.hosts=[h0,h1,h2]", "+world.trainer_procs=1", "world.actor_fraction=0",
                           "world.finetune_fraction=0", "world.replicas=2"],
    "split_kl_hosts": ["+world.hosts=[h0,h1]", "+world.trainer_procs=1", "finetune=ppo"],
    "trainer_world": ["+world.hosts=[h0,h1]", "+world.trainer_procs=2", "world.replicas=2"],
}


def pair(overrides: list[str]):
    ov = [*overrides, "output_dir=/tmp/unused", "launch_mode=processes"]
    # the JAX CLI selects a config group through a defaults entry; its
    # compose takes the group's keys as overrides
    jax_ov = [o for o in ov if not o.startswith("finetune=")]
    if "finetune=ppo" in ov:
        jax_ov += ["finetune.rl.kl_coef=0.1", "finetune.rl.policy_loss=ppo"]
    return compose("bandit_cpu", ov), jax_compose("conf", "bandit_cpu", jax_ov)


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_worldmap_equals_jax(name):
    cfg, jcfg = pair(WORLDS[name])
    port, ref = WorldMap(cfg), JWorldMap(jcfg)
    assert port.to_config() == ref.to_config()
    assert port.llm_urls == ref.llm_urls
    assert port.ref_llm_urls == ref.ref_llm_urls
    assert port.needs_ref_engine == ref.needs_ref_engine
    assert port.use_stream_hub == ref.use_stream_hub
    assert port.stream_hub_addr == ref.stream_hub_addr
    assert port.environment_servers == ref.environment_servers
    assert port.num_trainers == ref.num_trainers
    assert [j.is_local for j in port.jobs] == [j.is_local for j in ref.jobs]


@pytest.mark.parametrize("overrides,same_as", [
    (["+parallel.pp=2"], []),
])
def test_unported_layouts_raise(overrides, same_as):
    """The layouts the port once refused: ``parallel.pp=2`` lays out the
    jobs that JAX's WorldMap lays out for it, and that either package lays
    out without it (the JAX package reads no ``parallel.pp``)."""
    cfg, jcfg = pair(overrides)
    port, ref = WorldMap(cfg), JWorldMap(jcfg)
    assert port.to_config() == ref.to_config() == WorldMap(pair(same_as)[0]).to_config()
    assert port.llm_urls == ref.llm_urls and port.num_trainers == ref.num_trainers
