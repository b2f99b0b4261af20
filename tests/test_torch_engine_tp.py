"""The port's tensor-parallel engine (``engine.tp``, ``inference/tp_ranks.py``)
on two gloo rank processes, against the port at tp 1 and the JAX engine at
tp 2 on conftest's virtual devices: greedy tokens and logprobs on the slab
and paged layouts (GRPO forks, a prefix reuse), a sampled batch, a push
while decoding (each rank's weights equal its slice of the pushed tree),
``score_tokens``, an abort, the ranks' agreement window by window, a model
whose K does not split over tp, one whose H does not split over tp 4, and
the ``launch`` paths: the DRY_RUN job list with engine and trainer ranks on
their card slots, and ``bandit_cpu`` at ``engine.tp=2 parallel.tp=2``.

fp32 on the CPU: the ranks' sums run in another order than one device's,
so logprobs agree within ``LP_ATOL`` and greedy tokens exactly."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pipelinerl_tpu_torch.inference import engine as te
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.parallel.multihost import run_world

torch.set_num_threads(1)
HERE = str(Path(__file__).resolve().parent)
EOS = 250
KW = dict(vocab_size=260, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2)
LP_ATOL = 1e-4  # fp32 logprobs, the tp ranks' partial sums added in another order
PUSH_VERSION = 3


def engine_cfg(layout: str, **over) -> te.EngineConfig:
    """``tests/test_engine_paged.py``'s engine, fp32."""
    kw = dict(max_slots=4, max_len=96, prefill_buckets=(32, 64), decode_window=4, window_pipeline_depth=1,
              kv_layout=layout, kv_block_size=16, cache_dtype=torch.float32)
    kw.update(over)
    return te.EngineConfig(**kw)


def workload(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 200, n).tolist() for n in (5, 17, 31, 23)]
    group = [rng.integers(1, 200, 20).tolist()] * 3
    return {"greedy": prompts + group, "sampled": [rng.integers(1, 200, 12).tolist() for _ in range(4)],
            "during_push": [rng.integers(1, 200, 9).tolist() for _ in range(3)],
            "after_push": prompts[:2] + [prompts[2] + [7, 9, 11]], "score": rng.integers(1, 200, 40).tolist(),
            "long": rng.integers(1, 200, 10).tolist()}


def greedy(prompt, max_tokens=10, rid=""):
    return te.GenRequest(list(prompt), te.SamplingParams(temperature=0.0, max_tokens=max_tokens), request_id=rid)


def sampled(prompt):
    return te.GenRequest(list(prompt), te.SamplingParams(temperature=1.0, top_p=0.9, max_tokens=12))


def drain(engine, futures):
    for _ in range(3000):
        engine.step()
        if all(f.done() for f in futures):
            return [f.result() for f in futures]
    raise TimeoutError("engine did not finish")


def scaled(params: dict, c: float) -> dict:
    return {k: scaled(v, c) if isinstance(v, dict) else v * c for k, v in params.items()}


def as_lists(results) -> list[dict]:
    return [{"tokens": r.token_ids, "logprobs": r.logprobs, "finish": r.finish_reason} for r in results]


def drive(engine: te.InferenceEngine, params: dict, w: dict, push: bool) -> dict:
    """The workload on an engine stepped by hand: greedy prompts with a
    GRPO group, a sampled batch, a push of 0.5x the weights while a batch
    decodes, greedy prompts on the new weights (one extends a cached
    prefix), a score and an abort."""
    out = {"greedy": as_lists(drain(engine, [engine.submit(greedy(p)) for p in w["greedy"]])),
           "sampled": as_lists(drain(engine, [engine.submit(sampled(p)) for p in w["sampled"]]))}
    futures = [engine.submit(greedy(p, 24)) for p in w["during_push"]]
    engine.step()
    engine.step()
    if push:
        from pipelinerl_tpu_torch.inference.weight_transfer import serialize_params

        engine.update_params_serialized(bytes(serialize_params(scaled(params, 0.5), PUSH_VERSION)))
    else:
        engine.update_params(scaled(params, 0.5), PUSH_VERSION)
    drain(engine, futures)
    for _ in range(2000):
        if engine.version == PUSH_VERSION:
            break
        engine.step()
        if engine.version != PUSH_VERSION:
            import time

            time.sleep(0.002)
    out["version"] = engine.version
    out["after_push"] = as_lists(drain(engine, [engine.submit(greedy(p)) for p in w["after_push"]]))
    out["score"] = engine.score_tokens(w["score"])
    long = engine.submit(greedy(w["long"], 60, rid="long"))
    for _ in range(3):
        engine.step()
    engine.abort("long")
    (aborted,) = drain(engine, [long])
    out["abort"] = [aborted.finish_reason, len(aborted.token_ids)]
    return out


def _rank_engine(rank, n, data, out, layout, shape):
    from pipelinerl_tpu_torch.inference.tp_ranks import join_engine_world

    d = torch.load(data, weights_only=False)
    cfg = tt.ModelConfig(**{**KW, **shape}, dtype=torch.float32)
    params = tt.params_from_numpy(d["params"], cfg, "cpu")
    world = join_engine_world(rank, n, "", torch.device("cpu"))
    engine = te.InferenceEngine(params, cfg, engine_cfg(layout), eos_token_id=EOS, device="cpu", tp_world=world)
    result = {"cache_heads": (engine.k_pool if engine.paged else engine.k_cache).shape[-2],
              "wq": tuple(engine.params["layers"]["wq"].shape)}
    if rank == 0:
        result.update(drive(engine, params, d["workload"], push=True))
        result["checksums"] = engine.rank_checksums()
        engine.stop()
    else:
        engine.serve_tp_worker()
    result["digest"] = engine.window_digest
    torch.save(result, f"{out}/rank{rank}.pt")


def tp_world_run(tmp_path: Path, layout: str, shape: dict | None = None, n: int = 2) -> tuple[list[dict], dict,
                                                                                                 dict]:
    """``n`` engine ranks → (each rank's results, the params as numpy, the
    workload)."""
    import jax

    from pipelinerl_tpu.models.transformer import ModelConfig, init_params

    shape = shape or {}
    params = jax.tree.map(np.asarray, init_params(jax.random.key(0), ModelConfig(**{**KW, **shape},
                                                                                dtype=np.float32)))
    w = workload()
    torch.save({"params": params, "workload": w}, tmp_path / "data.pt")
    run_world("test_torch_engine_tp:_rank_engine", n, {"data": str(tmp_path / "data.pt"), "out": str(tmp_path),
                                                       "layout": layout, "shape": shape},
              timeout=240.0, pythonpath=[HERE])
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(n)], params, w


def assert_same(got: list[dict], want: list[dict], atol: float = LP_ATOL) -> None:
    for g, w in zip(got, want, strict=True):
        assert g["tokens"] == w["tokens"]
        assert g["finish"] == w["finish"]
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], rtol=0, atol=atol)


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_tp_engine_matches_tp1_and_jax_tp2(tmp_path, layout):
    """Two ranks against the port at tp 1 (every phase of ``drive``) and
    the JAX engine at tp 2 on a tp mesh of virtual devices (greedy tokens
    and logprobs on the first and on the pushed weights): greedy tokens equal,
    logprobs within ``LP_ATOL``; the sampled batch's tokens equal tp 1's
    (same generator seed, logits gathered before the sampler); the push
    landed on both ranks, each rank's weights equal to its slice of the
    pushed tree; both ranks read back the same windows."""
    from pipelinerl_tpu_torch.inference.server import param_checksums
    from pipelinerl_tpu_torch.parallel.sharding import tp_local

    ranks, params_np, w = tp_world_run(tmp_path, layout)
    r0 = ranks[0]
    assert [r["cache_heads"] for r in ranks] == [1, 1]
    assert [r["wq"] for r in ranks] == [(2, 32, 16)] * 2
    assert ranks[0]["digest"] == ranks[1]["digest"] != 0
    cfg = tt.ModelConfig(**KW, dtype=torch.float32)
    params = tt.params_from_numpy(params_np, cfg, "cpu")
    one = te.InferenceEngine(params, cfg, engine_cfg(layout), eos_token_id=EOS, device="cpu")
    ref = drive(one, params, w, push=False)
    for key in ("greedy", "after_push"):
        assert_same(r0[key], ref[key])
    assert [s["tokens"] for s in r0["sampled"]] == [s["tokens"] for s in ref["sampled"]]
    np.testing.assert_allclose(r0["score"], ref["score"], rtol=0, atol=LP_ATOL)
    assert r0["version"] == ref["version"] == PUSH_VERSION
    assert r0["abort"][0] == "abort" and r0["abort"][1] < 60
    pushed = scaled(params, 0.5)
    for rank, sums in enumerate(r0["checksums"]):
        assert sums == param_checksums(tp_local(pushed, rank, 2)), f"rank {rank}"

    for key, scale in (("greedy", 1.0), ("after_push", 0.5)):
        assert_same(r0[key], jax_greedy(params_np, KW, layout, w[key], scale))


def jax_greedy(params_np: dict, shape: dict, layout: str, prompts: list, scale: float, tp: int = 2,
               pp: int = 1) -> list[dict]:
    """The JAX engine on a ``(tp, pp)`` mesh of virtual devices, on
    ``scale`` times the weights: greedy results of ``prompts``."""
    import jax
    import jax.numpy as jnp

    from pipelinerl_tpu.inference import engine as je
    from pipelinerl_tpu.models import transformer as jt

    engine = je.InferenceEngine(jax.tree.map(lambda a: jnp.asarray(a) * scale, params_np),
                                jt.ModelConfig(dtype=jnp.float32, **shape),
                                je.EngineConfig(cache_dtype=jnp.float32, tp=tp, pp=pp, max_slots=4, max_len=96,
                                                prefill_buckets=(32, 64), decode_window=4, window_pipeline_depth=1,
                                                kv_layout=layout, kv_block_size=16), eos_token_id=EOS)
    assert (engine.mesh is not None) == (tp * pp > 1)
    futures = [engine.submit(je.GenRequest(list(p), je.SamplingParams(temperature=0.0, max_tokens=10)))
               for p in prompts]
    return [{"tokens": r.token_ids, "logprobs": r.logprobs, "finish": r.finish_reason} for r in drain(engine, futures)]


def test_tp_engine_with_kv_heads_that_do_not_split(tmp_path):
    """K 1 over tp 2: each rank's cache holds the one KV head its query
    heads read (``wk``/``wv`` whole on each rank); greedy tokens equal the
    port's at tp 1 and the JAX engine's at tp 2 (whose cache spec replicates
    such a head)."""
    shape = {"num_kv_heads": 1}
    ranks, params_np, w = tp_world_run(tmp_path, "slab", shape)
    assert [r["cache_heads"] for r in ranks] == [1, 1]
    cfg = tt.ModelConfig(**{**KW, **shape}, dtype=torch.float32)
    params = tt.params_from_numpy(params_np, cfg, "cpu")
    one = te.InferenceEngine(params, cfg, engine_cfg("slab"), eos_token_id=EOS, device="cpu")
    ref = drive(one, params, w, push=False)
    assert_same(ranks[0]["greedy"], ref["greedy"])
    assert_same(ranks[0]["after_push"], ref["after_push"])
    assert_same(ranks[0]["greedy"], jax_greedy(params_np, {**KW, **shape}, "slab", w["greedy"], 1.0))


def test_tp_engine_refuses_heads_that_do_not_split(tmp_path):
    """H 6 (K 2) over tp 4, which the port once refused: the ranks hold 2,
    2, 1 and 1 query heads (``tt.tp_heads``) and caches of 1, 2, 1 and 1
    KV heads; greedy tokens equal the port's at tp 1 and the JAX engine's
    at tp 4 (GSPMD reshards its flat head columns), logprobs within
    ``LP_ATOL``; every rank read back the same windows."""
    shape = {"num_heads": 6, "num_kv_heads": 2, "hidden_size": 48}
    ranks, params_np, w = tp_world_run(tmp_path, "slab", shape, n=4)
    assert [r["cache_heads"] for r in ranks] == [1, 2, 1, 1]
    assert [r["wq"] for r in ranks] == [(2, 48, 16), (2, 48, 16), (2, 48, 8), (2, 48, 8)]
    assert len({r["digest"] for r in ranks}) == 1 and ranks[0]["digest"] != 0
    cfg = tt.ModelConfig(**{**KW, **shape}, dtype=torch.float32)
    params = tt.params_from_numpy(params_np, cfg, "cpu")
    one = te.InferenceEngine(params, cfg, engine_cfg("slab"), eos_token_id=EOS, device="cpu")
    ref = drive(one, params, w, push=False)
    assert_same(ranks[0]["greedy"], ref["greedy"])
    assert_same(ranks[0]["after_push"], ref["after_push"])
    assert ranks[0]["version"] == PUSH_VERSION
    assert_same(ranks[0]["greedy"], jax_greedy(params_np, {**KW, **shape}, "slab", w["greedy"], 1.0, tp=4))


def test_dry_run_lists_engine_and_trainer_ranks_on_their_slots(tmp_path, monkeypatch):
    """``engine.tp=2 parallel.tp=2``, inline by default, switches to
    processes mode: its DRY_RUN lists the engine's two rank jobs (rank 0
    alone with a port, both with the engine's coordinator), two trainer
    ranks, and each card job on its own card slot, the engine's ranks
    first."""
    from pipelinerl_tpu_torch import launch
    from pipelinerl_tpu_torch.config import compose
    from pipelinerl_tpu_torch.world import WorldMap

    monkeypatch.setenv("DRY_RUN", "1")
    with pytest.raises(SystemExit) as done:
        launch.main(["--config-name=bandit_cpu", f"output_dir={tmp_path}", "device=cpu", "engine.tp=2",
                     "parallel.tp=2"])
    assert done.value.code == 0
    scripts = sorted(p.name for p in tmp_path.glob("*/start_*.sh"))
    assert [s for s in scripts if "engine" in s or "trainer" in s] == [
        "start_engine_0.sh", "start_engine_rank_0.sh", "start_trainer_0.sh", "start_trainer_1.sh"]
    saved = json.loads((tmp_path / "conf" / "exp_config.json").read_text())
    assert saved["launch_mode"] == "processes"
    engines = [j for j in saved["jobs"] if "engine" in j["kind"]]
    assert [(j["kind"], j["tp_rank"], j["port"]) for j in engines] == [("engine", 0, 8080), ("engine_rank", 1, None)]
    assert {j["tp_coordinator"] for j in engines} == {"127.0.0.1:7299"}
    assert "+me.tp_rank=1" in (tmp_path / "engine_rank" / "start_engine_rank_0.sh").read_text()
    wm = WorldMap(compose("bandit_cpu", ["output_dir=/tmp/unused", "launch_mode=processes", "engine.tp=2",
                                         "parallel.tp=2"]))
    assert launch.card_slots(wm) == {"engine_0": 0, "engine_rank_0": 1, "trainer_0": 2, "trainer_1": 3}
    assert wm.llm_urls == ["http://127.0.0.1:8080"] and wm.num_trainers == 1


def test_bandit_cpu_through_launch_at_tp2(tmp_path):
    """``bandit_cpu`` through ``launch`` with ``engine.tp=2 parallel.tp=2``,
    four steps on the CPU: both trainer ranks step and publish the same
    version, every push from trainer rank 0 lands on both engine ranks,
    which read back the same windows."""
    import subprocess
    import sys

    from pipelinerl_tpu_torch.parallel.multihost import free_port

    cmd = [sys.executable, "-m", "pipelinerl_tpu_torch.launch", "--config-name=bandit_cpu", f"output_dir={tmp_path}",
           "device=cpu", "engine.tp=2", "parallel.tp=2", "finetune.max_train_steps=4",
           f"world.engine_start_port={free_port()}", f"world.coordinator_port={free_port()}",
           f"world.engine_tp_port={free_port()}"]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=str(Path(HERE).parent))
    assert done.returncode == 0, done.stderr[-3000:]
    jobs = json.loads(done.stdout.strip().splitlines()[-1])["jobs"]
    engine, follower = jobs["engine_0"], jobs["engine_rank_0"]
    ranks = [jobs["trainer_0"]["trainer"], jobs["trainer_1"]["trainer"]]
    assert all(r["completed_steps"] == 4 for r in ranks) and ranks[0] == ranks[1]
    assert engine["version"] == follower["version"] == ranks[0]["last_broadcasted_version"] > 0
    assert engine["push"]["pushes_completed"] == len(jobs["trainer_0"]["pushes"]) > 0
    assert engine["window_digest"] == follower["window_digest"] != 0
    assert (engine["tp_rank"], engine["tp_size"], follower["tp_rank"]) == (0, 2, 1)


def _rank_vlm(rank, n, data, out, layout):
    import test_torch_engine_vlm as vlm

    from pipelinerl_tpu_torch.inference.tp_ranks import join_engine_world
    from pipelinerl_tpu_torch.models import vision as tv

    d = torch.load(data, weights_only=False)
    cfg, vcfg = tt.ModelConfig(dtype=torch.float32, **vlm.MKW), tv.VisionConfig(dtype=torch.float32, **vlm.VKW)
    world = join_engine_world(rank, n, "", torch.device("cpu"))
    engine = te.InferenceEngine(tt.params_from_numpy(d["params"], cfg, "cpu"), cfg,
                                te.EngineConfig(cache_dtype=torch.float32, **vlm.engine_kw(layout)), eos_token_id=-1,
                                device="cpu", vision_params=tt.params_from_numpy(d["tower"], cfg, "cpu"),
                                vision_cfg=vcfg, tp_world=world)
    result = {}
    if rank == 0:
        got = drain(engine, [engine.submit(r) for r in vlm.requests(te, vlm.SPECS)])
        result["results"] = as_lists(got)
        engine.stop()
    else:
        engine.serve_tp_worker()
    result["digest"] = engine.window_digest
    torch.save(result, f"{out}/rank{rank}.pt")


@pytest.mark.parametrize("layout", ["slab", "paged"])
def test_vlm_engine_at_tp2_matches_jax_tp2(tmp_path, layout):
    """The JAX engine serves its toy VLM at tp 2 (the tower replicated, the
    text model sharded); so does the port: two ranks, each running the
    tower whole and its slice of the text model, give the JAX tp 2
    engine's greedy tokens and logprobs (``LP_ATOL``), visual requests
    beside text ones, on both layouts."""
    import jax
    import jax.numpy as jnp
    import test_torch_engine_vlm as vlm

    from pipelinerl_tpu.inference import engine as je
    from pipelinerl_tpu.models import transformer as jt
    from pipelinerl_tpu.models import vision as jv

    jcfg, jvcfg = jt.ModelConfig(dtype=jnp.float32, **vlm.MKW), jv.VisionConfig(dtype=jnp.float32, **vlm.VKW)
    jparams, jvparams = jt.init_params(jax.random.key(0), jcfg), jv.init_vision_params(jax.random.key(1), jvcfg)
    torch.save({"params": jax.tree.map(np.asarray, jparams), "tower": jax.tree.map(np.asarray, jvparams)},
               tmp_path / "data.pt")
    run_world("test_torch_engine_tp:_rank_vlm", 2, {"data": str(tmp_path / "data.pt"), "out": str(tmp_path),
                                                    "layout": layout}, timeout=240.0, pythonpath=[HERE])
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert ranks[0]["digest"] == ranks[1]["digest"] != 0
    engine = je.InferenceEngine(jparams, jcfg, je.EngineConfig(cache_dtype=jnp.float32, tp=2,
                                                               **vlm.engine_kw(layout)),
                                eos_token_id=-1, vision_params=jvparams, vision_cfg=jvcfg)
    assert engine.mesh is not None
    want = as_lists(drain(engine, [engine.submit(r) for r in vlm.requests(je, vlm.SPECS)]))
    assert_same(ranks[0]["results"], want)
