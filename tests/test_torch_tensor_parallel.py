"""Tensor parallelism in the port's trainer against the JAX package's mesh:
the rule table's dp and tp cuts and their round trip, Megatron's f and g
operators, the vocabulary-parallel statistics of the loss, one
``TrainerLoop`` step at tp 2, dp 2 x tp 2 and cp 2 x tp 2 (LoRA included)
against JAX's ``TrainerLoop`` on a mesh of virtual CPU devices, a model
whose K does not split over tp, one whose H does not split over tp 4 (the
forward and a step against JAX's GSPMD resharding, a tp 4 world's
checkpoint through the gather of unequal head pieces).

Each world is ``parallel.multihost.run_world``: one CPU process per rank
(one torch thread, a timeout) that imports this module for its rank
function; JAX is imported inside the tests only. fp32 throughout: the
port's results match JAX's up to the order of the sums (1e-5)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from pipelinerl_tpu_torch.config import compose
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.parallel import collectives, sharding
from pipelinerl_tpu_torch.parallel.mesh import axis_rank, make_mesh, tp_context
from pipelinerl_tpu_torch.parallel.multihost import run_world
from pipelinerl_tpu_torch.streams import set_streams_backend
from pipelinerl_tpu_torch.train import rl_loss as trl
from pipelinerl_tpu_torch.train.trainer import TrainerLoop, param_leaves

torch.set_num_threads(1)
HERE = str(Path(__file__).resolve().parent)
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2)
RTOL, ATOL = 1e-5, 1e-5  # fp32, the same sums in another order (test_torch_trainer_world.py)
STATS_TOL = 1e-5  # fp32 logsumexp and entropy, summed over two ranks' halves
LORA = ["finetune.lora.enabled=true", "finetune.lora.r=4", "finetune.lora.alpha=8",
        'finetune.lora.target_modules=["wq","wv","wdown"]']


def world(target: str, n: int, **kwargs) -> None:
    run_world(f"test_torch_tensor_parallel:{target}", n, kwargs, timeout=180.0, pythonpath=[HERE])


def rank_coords(rank: int, dp: int, cp: int, tp: int) -> tuple[int, int, int]:
    """(dp, cp, tp) coordinates of a global rank: tp innermost."""
    return rank // (cp * tp), (rank // tp) % cp, rank % tp


# -- rank functions -----------------------------------------------------------


def _rank_round_trip(rank, n, dp, tp, out):
    cfg = tt.ModelConfig(**TINY, attention_bias=True, qk_norm=True, dtype=torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    params["value_head"] = {"w": torch.randn(32, 1, generator=torch.Generator().manual_seed(4)), "b": torch.zeros(1)}
    mesh = make_mesh(dp, 1, tp)
    shards = sharding.shard_params(params, mesh)
    back = sharding.unshard_params(shards, mesh)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(param_leaves(back), param_leaves(params)))
    torch.save({"shards": {k: v.numpy() for k, v in param_leaves(shards)}, "same": same,
                "coords": [axis_rank(mesh, a) for a in ("dp", "cp", "tp")]}, f"{out}/rank{rank}.pt")


def _rank_f_g(rank, n, out):
    """y = g(tanh(f(x) @ W1_r) @ W2_r), W1 cut by columns and W2 by rows:
    y, d/dx and each rank's d/dW against the whole product's."""
    mesh = make_mesh(1, 1, n)
    tp = tp_context(mesh)
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3, 8, generator=gen, requires_grad=True)
    w1 = torch.randn(8, 6, generator=gen)
    w2 = torch.randn(6, 4, generator=gen)
    w1_r = w1.chunk(n, dim=1)[rank].clone().requires_grad_(True)  # column-parallel
    w2_r = w2.chunk(n, dim=0)[rank].clone().requires_grad_(True)  # row-parallel
    y = collectives.reduce_from_tp(torch.tanh(collectives.copy_to_tp(x, tp) @ w1_r) @ w2_r, tp)
    (y.square().sum()).backward()
    xr, w1f, w2f = x.detach().clone().requires_grad_(True), w1.clone().requires_grad_(True), \
        w2.clone().requires_grad_(True)
    (torch.tanh(xr @ w1f) @ w2f).square().sum().backward()
    # count_once: a replicated read whose gradient a later sum over tp counts
    t = torch.ones(4, requires_grad=True)
    collectives.count_once(t * 1.0, tp).sum().backward()
    torch.save({"y": y.detach(), "dx": x.grad, "dx_ref": xr.grad, "dw1": w1_r.grad,
                "dw1_ref": w1f.grad.chunk(n, dim=1)[rank], "dw2": w2_r.grad, "dw2_ref": w2f.grad.chunk(n, dim=0)[rank],
                "y_ref": torch.tanh(x.detach() @ w1) @ w2, "once": t.grad}, f"{out}/rank{rank}.pt")


def _rank_stats(rank, n, data, out, chunk):
    """The vocabulary-parallel statistics and their gradient w.r.t. the
    hidden states, through ``_token_stats_chunked`` (chunk) or the whole
    logits."""
    d = torch.load(data, weights_only=False)
    cfg = tt.ModelConfig(**TINY, dtype=torch.float32, valid_vocab=d["valid_vocab"])
    mesh = make_mesh(1, 1, n)
    tp = tp_context(mesh)
    local = sharding.tp_local(tt.params_from_numpy(d["params"], cfg, "cpu"), rank, n)
    h = torch.from_numpy(d["hidden"]).requires_grad_(True)
    ids = torch.from_numpy(d["ids"])
    if chunk:
        lp, ent = trl._token_stats_chunked(local, cfg, h, ids, d["temperature"], chunk, tp=tp)
    else:
        lp, ent = trl._token_stats_from_logits(tt.lm_head_logits(local, cfg, h, tp), ids, d["temperature"], tp)
    (lp.sum() + 0.3 * ent.sum()).backward()
    torch.save({"lp": lp.detach(), "ent": ent.detach(), "dh": h.grad}, f"{out}/rank{rank}.pt")


def _rank_trainer(rank, n, exp, data, out, overrides, steps, adapters=None):
    """``test_torch_trainer_world._rank_trainer`` with JAX's initial LoRA
    adapters copied in (the packages draw them from different generators)."""
    set_streams_backend("files")
    from test_torch_trainer_world import OVERRIDES

    cfg = compose("bandit_cpu", [f"output_dir={exp}", *OVERRIDES, *overrides])
    model_cfg = tt.ModelConfig(**TINY, dtype=torch.float32)
    params = tt.params_from_numpy(torch.load(data, weights_only=False), model_cfg, "cpu")
    pushed = {}
    trainer = TrainerLoop(cfg, params, model_cfg, exp, weight_update_cb=lambda p, v: pushed.update(p=p, v=v))
    if adapters:
        with torch.no_grad():
            for name, p in param_leaves(trainer.params):
                p.copy_(torch.from_numpy(torch.load(adapters, weights_only=False)[name]))
    trainer.run(max_steps=steps)
    named, state = trainer.gathered_state()
    if rank == 0:
        torch.save({"params": {k: v.detach().numpy() for k, v in named}, "metrics": trainer.metrics.__dict__,
                    "pushed": {k: v.numpy() for k, v in param_leaves(pushed.get("p", {}))},
                    "version": pushed.get("v"), "mesh": list(trainer.mesh.shape),
                    "embed_shard": tuple((trainer.frozen_params or trainer.params)["embed"].shape)},
                   f"{out}/rank0.pt")


# -- tests --------------------------------------------------------------------


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_tp_cuts_match_jax_and_round_trip(tmp_path, dp, tp):
    """Each rank's shard of every leaf equals the shard JAX's
    ``shard_params`` places on the device at the rank's (dp, cp, tp)
    coordinate of a ``make_mesh(dp * tp, tp=tp)``; ``unshard_params`` gives
    the leaves back bit for bit on every rank."""
    import jax

    from pipelinerl_tpu.parallel import make_mesh as j_mesh, shard_params as j_shard

    world("_rank_round_trip", dp * tp, dp=dp, tp=tp, out=str(tmp_path))
    cfg = tt.ModelConfig(**TINY, attention_bias=True, qk_norm=True, dtype=torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    params["value_head"] = {"w": torch.randn(32, 1, generator=torch.Generator().manual_seed(4)), "b": torch.zeros(1)}
    mesh = j_mesh(n_devices=dp * tp, tp=tp)
    sharded = dict(param_leaves(j_shard(jax.tree.map(lambda t: t.numpy(), params), mesh)))
    for rank in range(dp * tp):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        assert got["same"]
        assert got["coords"] == list(rank_coords(rank, dp, 1, tp))
        device = mesh.devices[got["coords"][0], 0, got["coords"][2], 0]
        for name, shard in got["shards"].items():
            ref = next(s.data for s in sharded[name].addressable_shards if s.device == device)
            np.testing.assert_array_equal(shard, np.asarray(ref), err_msg=f"rank {rank} {name}")


def test_f_and_g_gradients(tmp_path):
    """A column-parallel then row-parallel product between f and g, on two
    ranks: the output and d/dx equal the whole product's on every rank,
    each rank's weight gradients are its slices of the whole ones;
    ``count_once`` keeps the gradient on rank 0 alone."""
    world("_rank_f_g", 2, out=str(tmp_path))
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        torch.testing.assert_close(got["y"], got["y_ref"], rtol=1e-6, atol=1e-6)
        for key in ("dx", "dw1", "dw2"):
            torch.testing.assert_close(got[key], got[f"{key}_ref"], rtol=1e-5, atol=1e-6)
        assert torch.equal(got["once"], torch.full((4,), 1.0 if rank == 0 else 0.0))


@pytest.mark.parametrize("chunk", [None, 8])
def test_vocab_parallel_stats_match_jax(tmp_path, chunk):
    """Logprobs and entropy of every position, and the gradient of a sum
    of both w.r.t. the hidden states, on two ranks of 64 vocabulary rows
    each (``valid_vocab`` 100 falls inside rank 1's rows; a target in each
    rank's rows; temperature 0.7) against JAX's ``_token_stats_from_logits``
    on the whole head, whole and chunked (chunks of 8 positions)."""
    import jax
    import jax.numpy as jnp

    from pipelinerl_tpu.models.transformer import ModelConfig, init_params, lm_head_logits
    from pipelinerl_tpu.train.rl_loss import _token_stats_from_logits

    rng = np.random.default_rng(11)
    jcfg = ModelConfig(**TINY, dtype=jnp.float32, valid_vocab=100)
    params = jax.tree.map(np.asarray, init_params(jax.random.key(2), jcfg))
    hidden = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ids = rng.integers(0, 100, (2, 16)).astype(np.int64)
    ids[0, 3], ids[1, 5] = 10, 90  # a target on each rank
    temperature = 0.7
    torch.save({"params": params, "hidden": hidden, "ids": ids, "valid_vocab": 100, "temperature": temperature},
               tmp_path / "data.pt")
    world("_rank_stats", 2, data=str(tmp_path / "data.pt"), out=str(tmp_path), chunk=chunk)

    def objective(h):
        lp, ent = _token_stats_from_logits(lm_head_logits(params, jcfg, h), jnp.asarray(ids), temperature)
        return lp.sum() + 0.3 * ent.sum(), (lp, ent)

    (_, (lp, ent)), dh = jax.value_and_grad(objective, has_aux=True)(jnp.asarray(hidden))
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        np.testing.assert_allclose(got["lp"].numpy(), np.asarray(lp), rtol=STATS_TOL, atol=STATS_TOL)
        np.testing.assert_allclose(got["ent"].numpy(), np.asarray(ent), rtol=STATS_TOL, atol=STATS_TOL)
        np.testing.assert_allclose(got["dh"].numpy(), np.asarray(dh), rtol=STATS_TOL, atol=STATS_TOL)


@pytest.mark.parametrize("par", [("parallel.tp=2",), ("parallel.dp=2", "parallel.tp=2"),
                                 ("parallel.cp=2", "parallel.tp=2"),
                                 ("parallel.tp=2", "finetune.gradient_checkpointing=true"),
                                 ("parallel.dp=2", "parallel.tp=2", "finetune.optim=adafactor"),
                                 ("parallel.dp=2", "parallel.tp=2", *LORA)])
def test_trainer_step_at_tp_matches_jax_mesh(tmp_path, par):
    """Two steps of the port's TrainerLoop on its (dp, cp, tp) world
    against JAX's mesh TrainerLoop on the same rows and params: steps,
    samples, the last loss, the grad norm and every trained leaf within
    1e-5; the last push carried the gathered (merged, under LoRA) params.
    Adafactor computes each leaf's factored moments over the whole leaf,
    gathered over dp and tp, as optax does on JAX's mesh."""
    from test_torch_trainer_world import jax_mesh_trainer, tiny_params_np, write_rows

    dp = 2 if "parallel.dp=2" in par else 1
    cp = 2 if "parallel.cp=2" in par else 1
    exp = tmp_path / "port"
    write_rows(exp, 8, dp)
    torch.save(tiny_params_np(), tmp_path / "params.pt")
    adapters = None
    if "finetune.lora.enabled=true" in par:
        adapters = str(tmp_path / "adapters.pt")
        torch.save(jax_adapters(tiny_params_np()), adapters)
    world("_rank_trainer", dp * cp * 2, exp=str(exp), data=str(tmp_path / "params.pt"), out=str(tmp_path),
          overrides=list(par), steps=2, adapters=adapters)
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)
    ref_metrics, ref_params = jax_mesh_trainer(tmp_path, list(par))
    m = got["metrics"]
    assert got["mesh"] == [dp, cp, 2]
    assert got["embed_shard"] == (128 // dp, 16)
    assert (m["completed_steps"], m["samples"], m["passes"]) == (ref_metrics.completed_steps, ref_metrics.samples,
                                                                 ref_metrics.passes)
    np.testing.assert_allclose(m["train_loss"], ref_metrics.train_loss, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(m["grad_norm"], ref_metrics.grad_norm, rtol=RTOL)
    assert sorted(got["params"]) == sorted(ref_params)
    for name, ref in ref_params.items():
        np.testing.assert_allclose(got["params"][name], ref, rtol=RTOL, atol=ATOL, err_msg=name)
    assert got["version"] == m["samples"]
    assert sorted(name for name in got["pushed"]) == sorted(name for name, _ in param_leaves(
        tt.params_from_numpy(tiny_params_np(), tt.ModelConfig(**TINY, dtype=torch.float32), "cpu")))


def jax_adapters(params_np: dict) -> dict:
    """JAX's TrainerLoop's initial LoRA adapters (``key(seed + 7)``, the
    presets' seed 42) for ``LORA``, by leaf name."""
    import jax

    from pipelinerl_tpu.train.lora import LoRAConfig, init_lora_params

    cfg = LoRAConfig(enabled=True, r=4, alpha=8, target_modules=("wq", "wv", "wdown"))
    tree = init_lora_params(jax.random.key(42 + 7), jax.tree.map(np.asarray, params_np), cfg)
    return {k: np.asarray(v) for k, v in param_leaves(tree)}


def test_uneven_kv_heads_at_tp(tmp_path):
    """K 1 over tp 2 (and K 3 over tp 2, H 6): each rank holds the KV heads
    its query heads read from the whole ``wk``/``wv``; the forward logits and
    one step match JAX's mesh (its cache spec replicates such heads, and
    GSPMD reshards the weights)."""
    run_uneven(tmp_path, dict(num_heads=4, num_kv_heads=1))
    run_uneven(tmp_path / "k3", dict(num_heads=6, num_kv_heads=3, hidden_size=48))


def _rank_uneven(rank, n, data, out, shape):
    from pipelinerl_tpu_torch.parallel.train_step import make_sharded_train_step
    from pipelinerl_tpu_torch.parallel import shard_batch

    d = torch.load(data, weights_only=False)
    cfg = tt.ModelConfig(**{**TINY, **shape}, dtype=torch.float32)
    mesh = make_mesh(1, 1, n)
    kv = sharding.tp_cut(cfg, n)
    full = tt.params_from_numpy(d["params"], cfg, "cpu")
    tp = tp_context(mesh)
    batch = {k: torch.from_numpy(d["batch"][k]) for k in ("input_ids", "position_ids", "segment_ids")}
    with torch.no_grad():
        logits = collectives.gather_vocab(tt.forward(sharding.tp_local(full, rank, n, kv), cfg, batch["input_ids"],
                                                     batch["position_ids"], batch["segment_ids"], tp=tp), tp)
    shards = sharding.shard_params(full, mesh, kv)
    for _, p in param_leaves(shards):
        p.requires_grad_(True)

    def adamw(leaves):
        return torch.optim.AdamW(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)

    step = make_sharded_train_step(cfg, trl.RLLossConfig(batch_size=2), adamw, max_step=10, remat=False, mesh=mesh)
    shards, _, loss, metrics = step(shards, None, shard_batch(d["batch"], mesh), 0, 0.0)
    full = sharding.unshard_params(shards, mesh, kv)
    if rank == 0:
        torch.save({"loss": float(loss), "grad_norm": float(metrics["grad_norm"]), "wk": tuple(shards["layers"]["wk"].shape),
                    "params": {k: v.numpy() for k, v in param_leaves(full)}, "logits": logits.numpy()},
                   f"{out}/rank0.pt")


def run_uneven(tmp_path: Path, shape: dict, tp: int = 2) -> None:
    """One forward and one AdamW step on ``tp`` ranks against JAX's tp
    mesh: logits, loss, grad norm and every updated param within 1e-5."""
    import jax
    import jax.numpy as jnp
    import optax

    from pipelinerl_tpu.models.transformer import ModelConfig, forward, init_params
    from pipelinerl_tpu.parallel import make_mesh as j_mesh, make_sharded_train_step as j_step, shard_batch as j_sb
    from pipelinerl_tpu.parallel import shard_params as j_shard
    from pipelinerl_tpu.train.rl_loss import RLLossConfig
    from test_torch_parallel import tiny_batch

    tmp_path.mkdir(parents=True, exist_ok=True)
    jcfg = ModelConfig(**{**TINY, **shape}, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, init_params(jax.random.key(0), jcfg))
    batch = tiny_batch(2, 32, np.random.default_rng(0))
    torch.save({"params": params, "batch": batch}, tmp_path / "data.pt")
    world("_rank_uneven", tp, data=str(tmp_path / "data.pt"), out=str(tmp_path), shape=shape)
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)
    mesh = j_mesh(n_devices=tp, tp=tp)
    optimizer = optax.adamw(1e-3)
    step = j_step(jcfg, RLLossConfig(batch_size=2), optimizer, max_step=10, remat=False)
    jp = j_shard(jax.tree.map(jnp.asarray, params), mesh)
    with mesh:
        logits = forward(jp, jcfg, *(jnp.asarray(batch[k]) for k in ("input_ids", "position_ids", "segment_ids")))
    np.testing.assert_allclose(got["logits"], np.asarray(logits), rtol=RTOL, atol=ATOL)
    with mesh:
        jp, _, loss, metrics = step(jp, jax.jit(optimizer.init)(jp), j_sb(batch, mesh), jnp.zeros(()),
                                    jnp.asarray(0.0))
    assert got["wk"] == tuple(params["layers"]["wk"].shape)  # whole on each rank
    np.testing.assert_allclose(got["loss"], float(loss), rtol=RTOL)
    np.testing.assert_allclose(got["grad_norm"], float(metrics["grad_norm"]), rtol=RTOL)
    for name, ref in param_leaves(jax.tree.map(np.asarray, jp)):
        np.testing.assert_allclose(got["params"][name], ref, rtol=RTOL, atol=ATOL, err_msg=name)


UNEVEN_HEADS = {"num_heads": 6, "num_kv_heads": 2, "hidden_size": 48}


def test_heads_that_do_not_split_raise_where_jax_reshards(tmp_path):
    """H 6 over tp 4, where the port once refused and JAX's GSPMD reshards
    the flat head columns: the ranks hold contiguous blocks of 2, 2, 1 and 1
    query heads (at G 2, 1, 1, 1 over the KV heads they read), and the
    forward logits and one step's loss, grad norm and params are within
    1e-5 of JAX's tp 4 mesh."""
    cfg = tt.ModelConfig(**{**TINY, **UNEVEN_HEADS}, dtype=torch.float32)
    assert [tt.tp_heads(cfg, collectives.TP(None, r, 4)) for r in range(4)] == [(2, [0]), (2, [0, 1]), (1, [1]),
                                                                                (1, [1])]
    assert sharding.tp_cut(cfg, 4).sizes("wq", 4) == [16, 16, 8, 8]
    run_uneven(tmp_path, UNEVEN_HEADS, tp=4)


def _rank_uneven_ckpt(rank, n, exp, data, out, steps, resume):
    set_streams_backend("files")
    from test_torch_trainer_world import OVERRIDES

    cfg = compose("bandit_cpu", [f"output_dir={exp}", *OVERRIDES, f"parallel.tp={n}",
                                 "finetune.save_checkpoint_steps=1"])
    model_cfg = tt.ModelConfig(**{**TINY, **UNEVEN_HEADS}, dtype=torch.float32)
    trainer = TrainerLoop(cfg, tt.params_from_numpy(torch.load(data, weights_only=False), model_cfg, "cpu"),
                          model_cfg, exp)
    if resume:
        assert trainer.try_resume()
    else:
        trainer.run(max_steps=steps)
    named, state = trainer.gathered_state()
    if rank == 0:
        torch.save({"params": {k: v.numpy() for k, v in named}, "metrics": trainer.metrics.__dict__,
                    "exp_avg": {i: s["exp_avg"].numpy() for i, s in state["state"].items()}}, f"{out}/rank0.pt")
    torch.save({"wq": tuple(trainer.params["layers"]["wq"].shape)}, f"{out}/shape{rank}.pt")


def test_tp4_checkpoint_with_heads_that_do_not_split(tmp_path):
    """A tp 4 world at H 6 saves after one step through the gather of
    unequal head pieces (rank 0 writes it); a second tp 4 world and a single
    process each resume it: the same params and Adam moments, bit for bit;
    the saved params are one step away from the initial ones."""
    import jax

    from pipelinerl_tpu.models.transformer import ModelConfig, init_params
    from test_torch_trainer_world import OVERRIDES, write_rows

    exp = tmp_path / "port"
    write_rows(exp, 4, 1)
    params_np = jax.tree.map(np.asarray, init_params(jax.random.key(0), ModelConfig(**{**TINY, **UNEVEN_HEADS},
                                                                                   dtype=np.float32)))
    torch.save(params_np, tmp_path / "params.pt")
    for name, steps, resume in (("a", 1, False), ("b", 0, True)):
        (tmp_path / name).mkdir()
        world("_rank_uneven_ckpt", 4, exp=str(exp), data=str(tmp_path / "params.pt"), out=str(tmp_path / name),
              steps=steps, resume=resume)
    a, b = (torch.load(tmp_path / x / "rank0.pt", weights_only=False) for x in "ab")
    assert [torch.load(tmp_path / "a" / f"shape{r}.pt")["wq"] for r in range(4)] == [(2, 48, 16)] * 2 + [(2, 48, 8)] * 2
    assert a["metrics"]["completed_steps"] == 1 and b["metrics"]["completed_steps"] == 1
    assert sorted(a["params"]) == sorted(name for name, _ in param_leaves(tt.params_from_numpy(
        params_np, tt.ModelConfig(**{**TINY, **UNEVEN_HEADS}, dtype=torch.float32), "cpu")))
    assert a["params"]["layers.wq"].shape == params_np["layers"]["wq"].shape
    assert not np.array_equal(a["params"]["layers.wq"], params_np["layers"]["wq"])
    for name in a["params"]:
        np.testing.assert_array_equal(b["params"][name], a["params"][name])
    for i in a["exp_avg"]:
        np.testing.assert_array_equal(b["exp_avg"][i], a["exp_avg"][i])
    set_streams_backend("files")
    cfg = compose("bandit_cpu", [f"output_dir={exp}", *OVERRIDES])
    model_cfg = tt.ModelConfig(**{**TINY, **UNEVEN_HEADS}, dtype=torch.float32)
    trainer = TrainerLoop(cfg, tt.params_from_numpy(params_np, model_cfg, "cpu"), model_cfg, str(exp))
    assert trainer.try_resume() and trainer.metrics.completed_steps == 1
    for name, p in param_leaves(trainer.params):
        np.testing.assert_array_equal(p.detach().numpy(), a["params"][name])


def test_tp_world_checkpoint_saves_and_resumes(tmp_path):
    """A dp 1 x tp 2 world saves after one step (rank 0 writes the state
    gathered over tp); a second tp 2 world and a single process each resume
    it: the same params and Adam moments, bit for bit."""
    import json

    from test_torch_trainer_world import OVERRIDES, tiny_params_np, write_rows

    exp = tmp_path / "port"
    write_rows(exp, 4, 1)
    torch.save(tiny_params_np(), tmp_path / "params.pt")
    ov = ["parallel.tp=2", "finetune.save_checkpoint_steps=1"]
    for name in "ab":
        (tmp_path / name).mkdir()
    for name, steps, resume in (("a", 1, False), ("b", 0, True)):
        run_world("test_torch_trainer_world:_rank_trainer", 2,
                  {"exp": str(exp), "data": str(tmp_path / "params.pt"), "out": str(tmp_path / name), "overrides": ov,
                   "steps": steps, "resume": resume}, timeout=180.0, pythonpath=[HERE])
    a, b = (torch.load(tmp_path / x / "rank0.pt", weights_only=False) for x in "ab")
    assert a["metrics"]["completed_steps"] == 1 and b["metrics"]["completed_steps"] == 1
    assert a["shard_rows"] == (128, 16)  # the embedding cut over tp along D
    for name in a["params"]:
        np.testing.assert_array_equal(b["params"][name], a["params"][name])
    for i in a["exp_avg"]:
        np.testing.assert_array_equal(b["exp_avg"][i], a["exp_avg"][i])
    set_streams_backend("files")
    cfg = compose("bandit_cpu", [f"output_dir={exp}", *OVERRIDES])
    model_cfg = tt.ModelConfig(**TINY, dtype=torch.float32)
    trainer = TrainerLoop(cfg, tt.params_from_numpy(torch.load(tmp_path / "params.pt", weights_only=False),
                                                    model_cfg, "cpu"), model_cfg, str(exp))
    assert trainer.try_resume() and trainer.metrics.completed_steps == 1
    for name, p in param_leaves(trainer.params):
        np.testing.assert_array_equal(p.detach().numpy(), a["params"][name])
    assert json.loads((exp / "finetune" / "training_state" / "metrics.json").read_text())["completed_steps"] == 1
