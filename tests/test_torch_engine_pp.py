"""The port's pipeline-parallel engine (``engine.pp``, alone and with
``engine.tp``; ``inference/tp_ranks.py``) on gloo rank processes, against
the port on one rank and the JAX engine at the same ``(tp, pp)`` on
conftest's virtual devices (``tests/test_engine.py``'s pp cases): greedy
tokens and logprobs on the slab and paged layouts (GRPO forks, a prefix
reuse), a sampled batch, a push while decoding (each rank's weights equal
its stage's slice of the pushed tree), ``score_tokens``, an abort and the
ranks' agreement window by window; the VLM prefill at pp 2; pp 3 on 2
layers; a one-layer model's GRPO forks on one rank (each stage's share
here); and the ``launch`` paths: the DRY_RUN job list of ``engine.tp=2
engine.pp=2`` and ``bandit_cpu`` at ``engine.pp=2``.

At tp 1 each stage runs one rank's layers at one rank's shapes and the
last stage samples with the one-rank engine's generator, so every result
equals the one-rank engine's bit for bit. At tp 2 the ranks' sums run in
another order (fp32 on the CPU): logprobs agree within ``LP_ATOL`` and
greedy tokens exactly."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.parallel.multihost import run_world
from test_torch_engine_tp import EOS, KW, LP_ATOL, PUSH_VERSION, as_lists, assert_same, drain, drive, engine_cfg, \
    greedy, jax_greedy, scaled, workload

torch.set_num_threads(1)
HERE = str(Path(__file__).resolve().parent)


def _rank_engine(rank, n, data, out, layout, pp):
    from pipelinerl_tpu_torch.inference.tp_ranks import join_engine_world

    d = torch.load(data, weights_only=False)
    cfg = tt.ModelConfig(**KW, dtype=torch.float32)
    params = tt.params_from_numpy(d["params"], cfg, "cpu")
    world = join_engine_world(rank, n, "", torch.device("cpu"), pp=pp)
    engine = te.InferenceEngine(params, cfg, engine_cfg(layout), eos_token_id=EOS, device="cpu", tp_world=world)
    result = {"cache": tuple((engine.k_pool if engine.paged else engine.k_cache).shape),
              "top": sorted(k for k in engine.params if k != "layers"), "stage": world.stage}
    if rank == 0:
        result.update(drive(engine, params, d["workload"], push=True))
        result["checksums"] = engine.rank_checksums()
        engine.stop()
    else:
        engine.serve_tp_worker()
    result["digest"] = engine.window_digest
    torch.save(result, f"{out}/rank{rank}.pt")


@pytest.mark.parametrize("tp,pp,layout", [(1, 2, "slab"), (1, 2, "paged"), (2, 2, "slab"), (2, 2, "paged")])
def test_pp_engine_matches_one_rank_and_jax(tmp_path, tp, pp, layout):
    """``tp * pp`` ranks against the port on one rank (every phase of
    ``drive``: bit for bit at tp 1) and the JAX engine at the same ``(tp,
    pp)`` (greedy tokens equal, logprobs within ``LP_ATOL``, on the first
    and on the pushed weights); each rank holds its stage's layers and top
    leaves and a cache of its stage's layers; the push landed on every
    rank, each rank's weights equal to its slice of the pushed tree; every
    rank read back the same windows."""
    import jax

    from pipelinerl_tpu.models.transformer import ModelConfig, init_params
    from pipelinerl_tpu_torch.inference.server import param_checksums
    from pipelinerl_tpu_torch.parallel.sharding import pp_local, tp_cut, tp_local

    params_np = jax.tree.map(np.asarray, init_params(jax.random.key(0), ModelConfig(**KW, dtype=np.float32)))
    w = workload()
    torch.save({"params": params_np, "workload": w}, tmp_path / "data.pt")
    n = tp * pp
    run_world("test_torch_engine_pp:_rank_engine", n, {"data": str(tmp_path / "data.pt"), "out": str(tmp_path),
                                                       "layout": layout, "pp": pp}, timeout=240.0, pythonpath=[HERE])
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(n)]
    assert [r["stage"] for r in ranks] == [r // tp for r in range(n)]
    assert all(r["cache"][0] == KW["num_layers"] // pp and r["cache"][-2] == KW["num_kv_heads"] // tp for r in ranks)
    # the embedding table on the first stage, the final norm and head on the last
    assert ranks[0]["top"] == ["embed"] and ranks[-1]["top"] == ["final_norm", "lm_head"]
    assert len({r["digest"] for r in ranks}) == 1 and ranks[0]["digest"] != 0
    r0 = ranks[0]
    cfg = tt.ModelConfig(**KW, dtype=torch.float32)
    params = tt.params_from_numpy(params_np, cfg, "cpu")
    one = te.InferenceEngine(params, cfg, engine_cfg(layout), eos_token_id=EOS, device="cpu")
    ref = drive(one, params, w, push=False)
    atol = 0.0 if tp == 1 else LP_ATOL
    for key in ("greedy", "after_push"):
        assert_same(r0[key], ref[key], atol)
    assert [s["tokens"] for s in r0["sampled"]] == [s["tokens"] for s in ref["sampled"]]
    if tp == 1:
        assert r0["sampled"] == ref["sampled"] and r0["score"] == ref["score"]
    np.testing.assert_allclose(r0["score"], ref["score"], rtol=0, atol=LP_ATOL)
    assert r0["version"] == ref["version"] == PUSH_VERSION
    assert r0["abort"][0] == "abort" and r0["abort"][1] < 60
    pushed = scaled(params, 0.5)
    cut = tp_cut(cfg, tp)
    for rank, sums in enumerate(r0["checksums"]):
        assert sums == param_checksums(tp_local(pp_local(pushed, rank // tp, pp), rank % tp, tp, cut)), f"rank {rank}"
    for key, scale in (("greedy", 1.0), ("after_push", 0.5)):
        assert_same(r0[key], jax_greedy(params_np, KW, layout, w[key], scale, tp, pp))


def _rank_vlm(rank, n, data, out, layout):
    import test_torch_engine_vlm as vlm

    from pipelinerl_tpu_torch.inference.tp_ranks import join_engine_world
    from pipelinerl_tpu_torch.models import vision as tv

    d = torch.load(data, weights_only=False)
    cfg, vcfg = tt.ModelConfig(dtype=torch.float32, **vlm.MKW), tv.VisionConfig(dtype=torch.float32, **vlm.VKW)
    world = join_engine_world(rank, n, "", torch.device("cpu"), pp=n)
    engine = te.InferenceEngine(tt.params_from_numpy(d["params"], cfg, "cpu"), cfg,
                                te.EngineConfig(cache_dtype=torch.float32, **vlm.engine_kw(layout)), eos_token_id=-1,
                                device="cpu", vision_params=tt.params_from_numpy(d["tower"], cfg, "cpu"),
                                vision_cfg=vcfg, tp_world=world)
    result = {}
    if rank == 0:
        result["results"] = as_lists(drain(engine, [engine.submit(r) for r in vlm.requests(te, vlm.SPECS)]))
        engine.stop()
    else:
        engine.serve_tp_worker()
    result["digest"] = engine.window_digest
    torch.save(result, f"{out}/rank{rank}.pt")


def test_vlm_prefill_at_pp2_matches_one_rank(tmp_path):
    """The toy VLM on two stages (the tower on the first, which splices its
    tokens; mrope positions on both): visual requests beside text ones give
    the one-rank port engine's greedy tokens and logprobs bit for bit."""
    import jax
    import test_torch_engine_vlm as vlm

    from pipelinerl_tpu.models import transformer as jt
    from pipelinerl_tpu.models import vision as jv
    from pipelinerl_tpu_torch.models import vision as tv

    import jax.numpy as jnp

    jcfg, jvcfg = jt.ModelConfig(dtype=jnp.float32, **vlm.MKW), jv.VisionConfig(dtype=jnp.float32, **vlm.VKW)
    params_np = jax.tree.map(np.asarray, jt.init_params(jax.random.key(0), jcfg))
    tower_np = jax.tree.map(np.asarray, jv.init_vision_params(jax.random.key(1), jvcfg))
    torch.save({"params": params_np, "tower": tower_np}, tmp_path / "data.pt")
    run_world("test_torch_engine_pp:_rank_vlm", 2, {"data": str(tmp_path / "data.pt"), "out": str(tmp_path),
                                                    "layout": "slab"}, timeout=240.0, pythonpath=[HERE])
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["digest"] == ranks[1]["digest"] != 0
    cfg, vcfg = tt.ModelConfig(dtype=torch.float32, **vlm.MKW), tv.VisionConfig(dtype=torch.float32, **vlm.VKW)
    one = te.InferenceEngine(tt.params_from_numpy(params_np, cfg, "cpu"), cfg,
                             te.EngineConfig(cache_dtype=torch.float32, **vlm.engine_kw("slab")), eos_token_id=-1,
                             device="cpu", vision_params=tt.params_from_numpy(tower_np, cfg, "cpu"), vision_cfg=vcfg)
    want = as_lists(drain(one, [one.submit(r) for r in vlm.requests(te, vlm.SPECS)]))
    assert ranks[0]["results"] == want


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_one_layer_engine_forks_as_jax(layout):
    """One rank at one layer (a stage's share of two layers at pp 2): a
    GRPO group's fork copies the prefilled slot's KV (it once raised on
    torch's overlap check, which takes the source slice and the indexed
    rows for one region at one layer); greedy tokens equal the JAX
    engine's, logprobs within ``LP_ATOL``."""
    import jax

    from pipelinerl_tpu.models.transformer import ModelConfig, init_params

    shape = {**KW, "num_layers": 1}
    params_np = jax.tree.map(np.asarray, init_params(jax.random.key(0), ModelConfig(**shape, dtype=np.float32)))
    cfg = tt.ModelConfig(**shape, dtype=torch.float32)
    engine = te.InferenceEngine(tt.params_from_numpy(params_np, cfg, "cpu"), cfg, engine_cfg(layout), eos_token_id=EOS,
                                device="cpu")
    prompts = workload()["greedy"]
    got = as_lists(drain(engine, [engine.submit(greedy(p)) for p in prompts]))
    assert engine.prefill_reused_tokens > 0  # the group forked
    assert_same(got, jax_greedy(params_np, shape, layout, prompts, 1.0, tp=1, pp=1))


def test_pp_rejects_indivisible_layers():
    """pp 3 on 2 layers raises JAX's words, in the engine and in the stage
    cut."""
    from pipelinerl_tpu_torch.inference.tp_ranks import EngineWorld
    from pipelinerl_tpu_torch.parallel.sharding import pp_local

    cfg = tt.ModelConfig(**KW, dtype=torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="num_layers 2 not divisible by pp=3"):
        te.InferenceEngine(params, cfg, engine_cfg("slab"), eos_token_id=EOS, device="cpu",
                           tp_world=EngineWorld(0, 3, None, None, None, pp=3))
    with pytest.raises(ValueError, match="not divisible by pp=3"):
        pp_local(params, 0, 3)


def test_dry_run_lists_four_engine_ranks_on_their_slots(tmp_path, monkeypatch):
    """``engine.tp=2 engine.pp=2`` switches to processes mode: its DRY_RUN
    lists the engine's four rank jobs (rank 0 alone with a port, all with
    the engine's coordinator and pp size), a trainer, and each card job on
    its own card slot, the engine's ranks first."""
    from pipelinerl_tpu_torch import launch
    from pipelinerl_tpu_torch.config import compose
    from pipelinerl_tpu_torch.world import WorldMap

    monkeypatch.setenv("DRY_RUN", "1")
    with pytest.raises(SystemExit) as done:
        launch.main(["--config-name=bandit_cpu", f"output_dir={tmp_path}", "device=cpu", "engine.tp=2",
                     "+engine.pp=2"])
    assert done.value.code == 0
    scripts = sorted(p.name for p in tmp_path.glob("*/start_*.sh"))
    assert [s for s in scripts if "engine" in s or "trainer" in s] == [
        "start_engine_0.sh", "start_engine_rank_0.sh", "start_engine_rank_1.sh", "start_engine_rank_2.sh",
        "start_trainer_0.sh"]
    saved = json.loads((tmp_path / "conf" / "exp_config.json").read_text())
    assert saved["launch_mode"] == "processes"
    engines = [j for j in saved["jobs"] if "engine" in j["kind"]]
    assert [(j["kind"], j["tp_rank"], j["port"]) for j in engines] == [
        ("engine", 0, 8080), ("engine_rank", 1, None), ("engine_rank", 2, None), ("engine_rank", 3, None)]
    assert {(j["tp_size"], j["pp_size"], j["tp_coordinator"]) for j in engines} == {(2, 2, "127.0.0.1:7299")}
    wm = WorldMap(compose("bandit_cpu", ["output_dir=/tmp/unused", "launch_mode=processes", "engine.tp=2",
                                         "+engine.pp=2"]))
    assert launch.card_slots(wm) == {"engine_0": 0, "engine_rank_0": 1, "engine_rank_1": 2, "engine_rank_2": 3,
                                     "trainer_0": 4}
    assert wm.llm_urls == ["http://127.0.0.1:8080"] and wm.num_trainers == 1


def test_bandit_cpu_through_launch_at_pp2(tmp_path):
    """``bandit_cpu`` through ``launch`` with ``engine.pp=2``, four steps
    on the CPU: the trainer steps, every push lands on both stages, which
    read back the same windows."""
    import subprocess
    import sys

    from pipelinerl_tpu_torch.parallel.multihost import free_port

    cmd = [sys.executable, "-m", "pipelinerl_tpu_torch.launch", "--config-name=bandit_cpu", f"output_dir={tmp_path}",
           "device=cpu", "+engine.pp=2", "finetune.max_train_steps=4", f"world.engine_start_port={free_port()}",
           f"world.coordinator_port={free_port()}", f"world.engine_tp_port={free_port()}"]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=str(Path(HERE).parent))
    assert done.returncode == 0, done.stderr[-3000:]
    jobs = json.loads(done.stdout.strip().splitlines()[-1])["jobs"]
    engine, follower, trainer = jobs["engine_0"], jobs["engine_rank_0"], jobs["trainer_0"]["trainer"]
    assert trainer["completed_steps"] == 4
    assert engine["version"] == follower["version"] == trainer["last_broadcasted_version"] > 0
    assert engine["push"]["pushes_completed"] == len(jobs["trainer_0"]["pushes"]) > 0
    assert engine["window_digest"] == follower["window_digest"] != 0
    assert (engine["tp_rank"], engine["tp_size"], engine["pp_size"], follower["tp_rank"]) == (0, 1, 2, 1)
