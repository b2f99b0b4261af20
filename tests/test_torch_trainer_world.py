"""The port's trainer world against the JAX package's mesh trainer:
``TrainerLoop`` on two gloo ranks (dp 2, and cp 2) against JAX's
``TrainerLoop`` on a mesh of virtual CPU devices (``test_trainer_mesh.py``);
a world's checkpoint saved and resumed (by a world and by one process);
``gather_for_push`` against the unsharded params; the WorldMap's trainer
jobs and the split layout's start scripts against JAX's; the preprocessor's
partitions per dp rank; and ``parallel.pp`` and ``engine.pp``, once
refused, beside the tp layouts that replaced the tp refusals."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pipelinerl_tpu_torch.config import Config, compose
from pipelinerl_tpu_torch.inference.weight_transfer import gather_for_push
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.parallel.multihost import run_world
from pipelinerl_tpu_torch.parallel.sharding import unshard_params
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamWriter, set_streams_backend
from pipelinerl_tpu_torch.train.trainer import TrainerLoop, param_leaves
from pipelinerl_tpu_torch.world import WorldMap

torch.set_num_threads(1)
HERE = str(Path(__file__).resolve().parent)
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2)
# fp32, the same sums in another order; Adam's update of a gradient at its
# eps scale moves by a part of lr (1e-3), so params also get 1e-5 absolute
RTOL, ATOL = 1e-5, 1e-5
OVERRIDES = ["finetune.samples_per_step=8", "finetune.max_train_steps=2", "finetune.seq_length=64",
             "finetune.learning_rate=1e-3", "finetune.num_warmup_steps=0", "finetune.gradient_checkpointing=false",
             "finetune.param_dtype=float32", "finetune.save_checkpoint_steps=0"]


def world(target: str, n: int, **kwargs) -> None:
    run_world(f"test_torch_trainer_world:{target}", n, kwargs, timeout=180.0, pythonpath=[HERE])


def tiny_params_np() -> dict:
    import jax
    import jax.numpy as jnp

    from pipelinerl_tpu.models.transformer import ModelConfig, init_params

    return jax.tree.map(np.asarray, init_params(jax.random.key(0), ModelConfig(**TINY, dtype=jnp.float32)))


def write_rows(exp: Path, n_rows: int, partitions: int) -> list[dict]:
    """JAX's trainer-mesh rows (``test_trainer_mesh.make_batch_msgs``): row
    ``i`` to partition ``i % partitions``, as one global batch of
    ``partitions`` rows a pass."""
    from test_trainer_mesh import make_batch_msgs

    msgs = make_batch_msgs(n_rows)
    set_streams_backend("files")
    writers = [StreamWriter(SingleStreamSpec(exp_path=str(exp), topic="training_data", partition=p))
               for p in range(partitions)]
    for i, msg in enumerate(msgs):
        writers[i % partitions].write(msg)
    for w in writers:
        w.close()
    return msgs


def _rank_trainer(rank, n, exp, data, out, overrides, steps, resume=False):
    set_streams_backend("files")
    cfg = compose("bandit_cpu", [f"output_dir={exp}", *OVERRIDES, *overrides])
    model_cfg = tt.ModelConfig(**TINY, dtype=torch.float32)
    params = tt.params_from_numpy(torch.load(data, weights_only=False), model_cfg, "cpu")
    pushed = {}
    trainer = TrainerLoop(cfg, params, model_cfg, exp, weight_update_cb=lambda p, v: pushed.update(p=p, v=v))
    if resume:
        assert trainer.try_resume()
    else:
        trainer.run(max_steps=steps)
    full = unshard_params(trainer.params, trainer.mesh)
    _, state = trainer.gathered_state()
    if rank == 0:
        torch.save({"params": {k: v.numpy() for k, v in param_leaves(full)},
                    "pushed": {k: v.numpy() for k, v in param_leaves(pushed.get("p", {}))},
                    "version": pushed.get("v"), "metrics": trainer.metrics.__dict__,
                    "exp_avg": {i: s["exp_avg"].numpy() for i, s in state["state"].items()},
                    "shard_rows": tuple(trainer.params["embed"].shape)}, f"{out}/rank0.pt")


def jax_mesh_trainer(tmp_path: Path, overrides: list[str]):
    """JAX's TrainerLoop on its mesh over the same rows (all on partition 0,
    the JAX trainer's one process buffering its dp rows)."""
    import jax
    import jax.numpy as jnp

    from pipelinerl_tpu.config import compose as j_compose
    from pipelinerl_tpu.models.transformer import ModelConfig
    from pipelinerl_tpu.streams import set_streams_backend as j_backend
    from pipelinerl_tpu.train.trainer import TrainerLoop as JTrainerLoop

    exp = tmp_path / "jax"
    write_rows(exp, 8, 1)
    j_backend("files")
    cfg = j_compose("conf", "bandit_cpu", [f"output_dir={exp}", *OVERRIDES, *(f"+{o}" for o in overrides)])
    trainer = JTrainerLoop(cfg, jax.tree.map(jnp.asarray, tiny_params_np()), ModelConfig(**TINY, dtype=jnp.float32),
                           str(exp))
    metrics = trainer.run(max_steps=2)
    return metrics, dict(param_leaves(jax.tree.map(np.asarray, trainer.params)))


@pytest.mark.parametrize("par", [("parallel.dp=2",), ("parallel.cp=2",),
                                 ("parallel.cp=2", "finetune.rl.policy_loss=gspo"),
                                 ("parallel.dp=2", "finetune.gradient_checkpointing=true")])
def test_trainer_world_matches_jax_mesh(tmp_path, par):
    """Two steps of the port's TrainerLoop on two gloo ranks (each rank
    reading its dp rank's partition) against JAX's mesh TrainerLoop on the
    same rows: the step count, the trained samples, the last loss, the grad
    norm and every param within 1e-5; the last push carried the gathered
    params."""
    dp = 2 if "parallel.dp=2" in par else 1
    exp = tmp_path / "port"
    write_rows(exp, 8, dp)
    torch.save(tiny_params_np(), tmp_path / "params.pt")
    world("_rank_trainer", 2, exp=str(exp), data=str(tmp_path / "params.pt"), out=str(tmp_path),
          overrides=list(par), steps=2)
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)
    ref_metrics, ref_params = jax_mesh_trainer(tmp_path, list(par))
    m = got["metrics"]
    assert (m["completed_steps"], m["samples"], m["passes"]) == (ref_metrics.completed_steps, ref_metrics.samples,
                                                                 ref_metrics.passes)
    np.testing.assert_allclose(m["train_loss"], ref_metrics.train_loss, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(m["grad_norm"], ref_metrics.grad_norm, rtol=RTOL)
    for name, ref in ref_params.items():
        np.testing.assert_allclose(got["params"][name], ref, rtol=RTOL, atol=ATOL, err_msg=name)
    assert got["shard_rows"] == (128 // dp, 32)
    assert got["version"] == m["samples"]
    for name, p in got["params"].items():  # gather_for_push: the unsharded params
        np.testing.assert_array_equal(got["pushed"][name], p)


def test_world_checkpoint_saves_and_resumes(tmp_path):
    """A dp 2 world saves after one step (rank 0 writes the gathered
    state); a second dp 2 world and a single process each resume it: the
    same params and Adam moments, bit for bit."""
    exp = tmp_path / "port"
    write_rows(exp, 4, 2)
    torch.save(tiny_params_np(), tmp_path / "params.pt")
    ov = ["parallel.dp=2", "finetune.save_checkpoint_steps=1"]
    for name in "ab":
        (tmp_path / name).mkdir()
    world("_rank_trainer", 2, exp=str(exp), data=str(tmp_path / "params.pt"), out=str(tmp_path / "a"),
          overrides=ov, steps=1)
    world("_rank_trainer", 2, exp=str(exp), data=str(tmp_path / "params.pt"), out=str(tmp_path / "b"),
          overrides=ov, steps=0, resume=True)
    a, b = (torch.load(tmp_path / x / "rank0.pt", weights_only=False) for x in "ab")
    assert a["metrics"]["completed_steps"] == 1 and b["metrics"]["completed_steps"] == 1
    for name in a["params"]:
        np.testing.assert_array_equal(b["params"][name], a["params"][name])
    for i in a["exp_avg"]:
        np.testing.assert_array_equal(b["exp_avg"][i], a["exp_avg"][i])
    # one process resumes the world's checkpoint
    set_streams_backend("files")
    cfg = compose("bandit_cpu", [f"output_dir={exp}", *OVERRIDES])
    model_cfg = tt.ModelConfig(**TINY, dtype=torch.float32)
    trainer = TrainerLoop(cfg, tt.params_from_numpy(torch.load(tmp_path / "params.pt", weights_only=False),
                                                    model_cfg, "cpu"), model_cfg, str(exp))
    assert trainer.try_resume() and trainer.metrics.completed_steps == 1
    for name, p in param_leaves(trainer.params):
        np.testing.assert_array_equal(p.detach().numpy(), a["params"][name])
    assert json.loads((exp / "finetune" / "training_state" / "metrics.json").read_text())["completed_steps"] == 1


def test_gather_for_push_without_a_mesh_is_the_identity():
    params = {"embed": torch.ones(4, 2)}
    assert gather_for_push(params, None) is params


def test_worldmap_trainer_jobs_equal_jax():
    """``tests/test_multihost_pipeline.py``'s split world (two hosts, two
    engines, two trainer processes, the hub): the same jobs, extras and
    partitions."""
    from pipelinerl_tpu.config import Config as JConfig
    from pipelinerl_tpu.world import WorldMap as JWorldMap

    body = {"world": {"hosts": ["10.0.0.1", "10.0.0.2"], "replicas": 2, "trainer_procs": 2, "stream_hub": True},
            "actor": {"replicas": 2}}
    port, ref = WorldMap(Config(json.loads(json.dumps(body)))), JWorldMap(JConfig(body))
    assert port.to_config() == ref.to_config()
    assert port.num_trainers == ref.num_trainers == 2
    assert [t.extra for t in port.jobs_of("trainer")] == [t.extra for t in ref.jobs_of("trainer")]


@pytest.mark.parametrize("par,ranks,partitions", [({"dp": 2}, 2, 2), ({"cp": 2}, 2, 1), ({"dp": 2, "cp": 2}, 4, 2),
                                                  ({"dp": 1, "cp": 8}, 8, 1)])
def test_trainer_ranks_and_partitions_per_dp_rank(par, ranks, partitions):
    """dp*cp trainer jobs, one training_data partition per dp rank (cp peers
    read the same one); with cp 1 that is JAX's one partition per trainer
    process."""
    cfg = compose("bandit_cpu", ["output_dir=/tmp/unused", "launch_mode=processes",
                                 *(f"+parallel.{k}={v}" for k, v in par.items())])
    wm = WorldMap(cfg)
    assert [j.extra["process_id"] for j in wm.jobs_of("trainer")] == list(range(ranks))
    assert wm.num_trainers == partitions


def test_preprocessor_writes_one_partition_per_dp_rank(tmp_path):
    """The preprocessor of a dp 2 x cp 2 world packs into two partitions,
    sentinels filling in, so both dp ranks see the same number of passes."""
    from pipelinerl_tpu_torch.preprocess import Preprocessor
    from pipelinerl_tpu_torch.state import TrainerState
    from pipelinerl_tpu_torch.streams import StreamReader
    from pipelinerl_tpu_torch.train.advantages import prepare_rl_fields

    set_streams_backend("files")
    cfg = compose("bandit_cpu", [f"output_dir={tmp_path}", "+parallel.dp=2", "+parallel.cp=2",
                                 "finetune.seq_length=64"])
    writer = StreamWriter(SingleStreamSpec(exp_path=str(tmp_path), topic="actor"))
    rng = np.random.default_rng(0)
    attempts = int(cfg.attempts)
    for g in range(3):
        writer.write({"group_id": f"g{g}", "samples": [prepare_rl_fields(
            {"input_ids": rng.integers(1, 100, 40).tolist(), "labels": [-100] * 4 + rng.integers(1, 100, 36).tolist(),
             "reward": float(r % 2), "logprobs": [-0.5] * 36, "group_id": f"g{g}", "rollout_index": r,
             "step_index": 0, "finished": True, "model_version": 0}) for r in range(attempts)]})
    writer.close()
    pre = Preprocessor(cfg, str(tmp_path), TrainerState(str(tmp_path)), eos_token_id=0,
                       num_trainers=WorldMap(Config(dict(cfg.to_dict(), launch_mode="processes"))).num_trainers)
    pre.run(max_groups=3)
    counts = [len(list(StreamReader(SingleStreamSpec(exp_path=str(tmp_path), topic="training_data",
                                                     partition=p)).read_available())) for p in range(2)]
    assert counts[0] == counts[1] > 0
    assert not list(Path(tmp_path, "streams", "training_data").glob("*/2.jsonl"))


@pytest.mark.parametrize("where", ["trainer_tp", "trainer_pp", "engine_tp", "engine_pp", "worldmap"])
def test_tp_and_pp_refusals_name_item_15(tmp_path, where):
    """The layouts once refused, each as the JAX package runs it: the
    trainer at ``parallel.pp=2`` trains as at pp 1 (neither package reads
    it) and matches JAX's TrainerLoop; ``engine.pp`` and ``engine.tp`` lay
    out engines of rank jobs (rank 0 alone an HTTP URL; one process without
    its rank world is refused, naming the rank processes); a trainer world
    of dp*cp*tp ranks; the WorldMap at ``parallel.pp=2`` is JAX's."""
    from pipelinerl_tpu_torch.launch import build_engine, validate_config
    from pipelinerl_tpu_torch.train.trainer import parallel_shape

    if where == "trainer_pp":
        cfg = compose("bandit_cpu", [f"output_dir={tmp_path}", "+parallel.pp=2"])
        validate_config(cfg)
        assert parallel_shape(cfg, 1) == (1, 1, 1)
        got = {}
        for pp in (2, 1):
            exp = tmp_path / f"port_pp{pp}"
            write_rows(exp, 8, 1)
            cfg = compose("bandit_cpu", [f"output_dir={exp}", *OVERRIDES, f"+parallel.pp={pp}"])
            model_cfg = tt.ModelConfig(**TINY, dtype=torch.float32)
            trainer = TrainerLoop(cfg, tt.params_from_numpy(tiny_params_np(), model_cfg, "cpu"), model_cfg, str(exp))
            trainer.run(max_steps=2)
            got[pp] = (trainer.metrics, {k: v.detach().numpy() for k, v in param_leaves(trainer.params)})
        (m, params), (m1, params1) = got[2], got[1]
        assert (m.completed_steps, m.samples, m.train_loss, m.grad_norm) == (m1.completed_steps, m1.samples,
                                                                             m1.train_loss, m1.grad_norm)
        for name, p in params.items():
            np.testing.assert_array_equal(p, params1[name])
        ref_metrics, ref_params = jax_mesh_trainer(tmp_path, ["parallel.pp=2"])
        assert (m.completed_steps, m.samples) == (ref_metrics.completed_steps, ref_metrics.samples) == (2, 16)
        np.testing.assert_allclose(m.train_loss, ref_metrics.train_loss, rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(m.grad_norm, ref_metrics.grad_norm, rtol=RTOL)
        for name, ref in ref_params.items():
            np.testing.assert_allclose(params[name], ref, rtol=RTOL, atol=ATOL, err_msg=name)
    elif where == "trainer_tp":
        cfg = compose("bandit_cpu", [f"output_dir={tmp_path}", "+parallel.tp=2"])
        validate_config(cfg)
        assert parallel_shape(cfg, 2) == (1, 1, 2)
        with pytest.raises(ValueError, match="needs a trainer world of a multiple of 2 ranks"):
            parallel_shape(cfg, 1)
    elif where == "engine_pp":
        cfg = compose("bandit_cpu", [f"output_dir={tmp_path}", "+engine.pp=2"])
        validate_config(cfg)
        wm = WorldMap(Config(dict(cfg.to_dict(), launch_mode="processes")))
        assert [(j.kind, j.extra.get("tp_rank"), j.extra.get("pp_size")) for j in wm.jobs if "engine" in j.kind] == [
            ("engine", 0, 2), ("engine_rank", 1, 2)]
        assert wm.llm_urls == ["http://127.0.0.1:8080"] and wm.trainer_procs == 1
        with pytest.raises(ValueError, match="engine.pp=2 runs as 2 engine rank processes"):
            build_engine(cfg, {}, None, None, "cpu")
    elif where == "engine_tp":
        cfg = compose("bandit_cpu", [f"output_dir={tmp_path}", "+engine.tp=2"])
        validate_config(cfg)
        wm = WorldMap(Config(dict(cfg.to_dict(), launch_mode="processes")))
        assert [(j.kind, j.extra.get("tp_rank")) for j in wm.jobs if "engine" in j.kind] == [("engine", 0),
                                                                                            ("engine_rank", 1)]
        assert wm.llm_urls == ["http://127.0.0.1:8080"] and wm.trainer_procs == 1
        with pytest.raises(ValueError, match="engine.tp=2 runs as 2 engine rank processes"):
            build_engine(cfg, {}, None, None, "cpu")
    else:
        cfg = compose("bandit_cpu", [f"output_dir={tmp_path}", "launch_mode=processes", "+parallel.tp=2"])
        wm = WorldMap(cfg)
        assert [j.extra["num_processes"] for j in wm.jobs_of("trainer")] == [2, 2] and wm.num_trainers == 1
        from pipelinerl_tpu.config import compose as j_compose
        from pipelinerl_tpu.world import WorldMap as JWorldMap

        ov = [f"output_dir={tmp_path}", "launch_mode=processes", "+parallel.pp=2"]
        port, ref = WorldMap(compose("bandit_cpu", ov)), JWorldMap(j_compose("conf", "bandit_cpu", ov))
        assert port.to_config() == ref.to_config() and port.num_trainers == ref.num_trainers


def test_tir_preset_validates_and_dry_runs_eight_ranks(tmp_path, monkeypatch):
    """``launch --config-name=tir`` with its own ``cp: 8`` passes
    ``validate_config`` and, inline by default, switches to processes mode:
    its DRY_RUN lists eight trainer ranks and one engine."""
    from pipelinerl_tpu_torch import launch

    monkeypatch.setenv("DRY_RUN", "1")
    with pytest.raises(SystemExit) as done:
        launch.main(["--config-name=tir", f"output_dir={tmp_path}", "model_path=toy", "device=cpu"])
    assert done.value.code == 0
    scripts = sorted(p.name for p in tmp_path.glob("*/start_*.sh"))
    assert [s for s in scripts if s.startswith("start_trainer_")] == [f"start_trainer_{i}.sh" for i in range(8)]
    assert "start_engine_0.sh" in scripts
    saved = json.loads((tmp_path / "conf" / "exp_config.json").read_text())
    assert saved["launch_mode"] == "processes"
    assert [j["num_processes"] for j in saved["jobs"] if j["kind"] == "trainer"] == [8] * 8


@pytest.mark.parametrize("hosts,want", [
    (["127.0.0.1"], {"engine_0": 0, **{f"trainer_{i}": 1 + i for i in range(8)}}),
    (["10.0.0.1", "10.0.0.2"], {"engine_0": 0, **{f"trainer_{i}": i for i in range(8)}}),
])
def test_card_jobs_take_their_own_slots(hosts, want):
    """The tir preset's world: the engine takes its host's first card slot
    and the eight trainer ranks the next ones, so on one host of nine cards,
    or with the engine on a host of its own, no two card jobs share a card."""
    from pipelinerl_tpu_torch.launch import card_slots

    world = [f"world.hosts={json.dumps(hosts)}"]
    if len(hosts) > 1:
        world += ["world.actor_fraction=1", "world.finetune_fraction=1"]
    wm = WorldMap(compose("tir", ["output_dir=/tmp/unused", "model_path=toy", *world]))
    assert card_slots(wm) == want
    assert len({j.hostname for j in wm.jobs_of("trainer")} & {j.hostname for j in wm.jobs_of("engine")}) == (
        len(hosts) == 1)
