"""The port's ``parallel/`` against the JAX package's: the mesh shape and the
rule table, the shard round trip, and the sharded train step on four gloo
ranks (dp 2 x cp 2) against JAX's ``make_sharded_train_step`` on a
``make_mesh(n_devices=4, cp=2)`` of virtual CPU devices.

Each world is ``parallel.multihost.run_world``: one CPU process per rank
(one torch thread, a timeout), which imports this module for its rank
function; JAX is imported inside the tests only."""

from pathlib import Path

import numpy as np
import pytest
import torch

from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.parallel import (
    infer_mesh_shape,
    make_mesh,
    make_sharded_train_step,
    param_partition_specs,
    shard_batch,
    shard_params,
    unshard_params,
)
from pipelinerl_tpu_torch.parallel.multihost import run_world
from pipelinerl_tpu_torch.train.rl_loss import RLLossConfig
from pipelinerl_tpu_torch.train.trainer import param_leaves

torch.set_num_threads(1)
HERE = str(Path(__file__).resolve().parent)
WORLD_TIMEOUT = 120.0
STEP_RTOL = 1e-5  # fp32: the same sums in another order
# Adam's first update is lr * g / (|g| + 1e-8): where a gradient is at the
# eps scale (fp32 cancellation noise of sums taken in another order) the
# update moves by a part of lr (1e-3); 1% of lr bounds it
STEP_ATOL = 1e-5
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2)


def world(target: str, n: int, **kwargs) -> None:
    run_world(f"test_torch_parallel:{target}", n, kwargs, timeout=WORLD_TIMEOUT, pythonpath=[HERE])


def tiny_batch(dp: int, L: int, rng) -> dict:
    """``tests/test_parallel.py``'s ``_tiny_batch`` through the port's
    packing: ``dp`` rows of one sample each."""
    from pipelinerl_tpu_torch.train.packing import pack_samples

    rows = []
    for _ in range(dp):
        n_prompt, n_out = 2, 6
        ids = rng.integers(1, 120, n_prompt + n_out).tolist()
        sample = {
            "input_ids": ids, "labels": [-100] * n_prompt + ids[n_prompt:], "rewards": [1.0] * len(ids),
            "advantages": [0.5] * len(ids), "ref_logprobs": [0.0] * len(ids),
            "old_logprobs": [0.0] * n_prompt + [-1.0] * n_out, "group_tokens": [float(len(ids))] * len(ids),
            "num_labels": [float(n_out)] * len(ids), "overflow": [0.0] * len(ids), "model_version": 0,
        }
        rows.append(pack_samples([sample], L, eos_token_id=0))
    return {name: np.concatenate([getattr(r, name) for r in rows], axis=0) for name in rows[0].arrays()}


def jax_tiny(seed: int = 0):
    """JAX's tiny fp32 model (``tests/test_parallel.py``) → (config, params
    as numpy)."""
    import jax
    import jax.numpy as jnp

    from pipelinerl_tpu.models.transformer import ModelConfig, init_params

    cfg = ModelConfig(**TINY, dtype=jnp.float32)
    return cfg, jax.tree.map(np.asarray, init_params(jax.random.key(seed), cfg))


# -- rank functions -----------------------------------------------------------


def _rank_round_trip(rank, n, dp, cp, out):
    cfg = tt.ModelConfig(**TINY, attention_bias=True, qk_norm=True, dtype=torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    params["value_head"] = {"w": torch.randn(32, 1, generator=torch.Generator().manual_seed(4)), "b": torch.zeros(1)}
    mesh = make_mesh(dp, cp)
    shards = shard_params(params, mesh)
    back = unshard_params(shards, mesh)
    sizes = {name: tuple(p.shape) for name, p in param_leaves(shards)}
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(param_leaves(back), param_leaves(params)))
    torch.save({"sizes": sizes, "same": same}, f"{out}/rank{rank}.pt")


def _rank_step(rank, n, dp, cp, data, out, policy):
    d = torch.load(data, weights_only=False)
    cfg = tt.ModelConfig(**TINY, dtype=torch.float32)
    mesh = make_mesh(dp, cp)
    shards = shard_params(tt.params_from_numpy(d["params"], cfg, "cpu"), mesh)
    for _, p in param_leaves(shards):
        p.requires_grad_(True)
    # optax.adamw(1e-3): weight decay 1e-4 on every leaf, applied to the
    # pre-update params, as torch's AdamW does
    def adamw(leaves):
        return torch.optim.AdamW(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)

    loss_cfg = RLLossConfig(policy_loss=policy, batch_size=2, max_segments=4)
    step = make_sharded_train_step(cfg, loss_cfg, adamw, max_step=10, remat=False, mesh=mesh)
    shards, opt, loss, metrics = step(shards, None, shard_batch(d["batch"], mesh), 0, 0.0)
    full = unshard_params(shards, mesh)
    if rank == 0:
        torch.save({"loss": float(loss), "grad_norm": float(metrics["grad_norm"]),
                    "params": {k: v.numpy() for k, v in param_leaves(full)}}, f"{out}/rank0.pt")


def _rank_layer_gather(rank, n, data, out, remat):
    """One forward and backward of the tiny model on dp ``n`` shards, a row
    a rank, counting the per-layer gathers, against the pass of every row
    on the full params in this process (the loss a sum over rows)."""
    from pipelinerl_tpu_torch.parallel import sharding

    d = torch.load(data, weights_only=False)
    cfg = tt.ModelConfig(**TINY, dtype=torch.float32)
    mesh = make_mesh(n, 1)
    full = tt.params_from_numpy(d["params"], cfg, "cpu")
    shards = shard_params(full, mesh)
    for tree in (full, shards):
        for _, p in param_leaves(tree):
            p.requires_grad_(True)
    inner, calls = sharding.layer_gather(mesh), []

    def gather(layer):
        calls.append(tuple(layer["wq"].shape))
        return inner(layer)

    ids, pos, seg = (torch.as_tensor(d["batch"][k]) for k in ("input_ids", "position_ids", "segment_ids"))
    ids, pos, seg = ids.long(), pos.long(), seg.int()
    mine = slice(rank, rank + 1)
    weights = sharding.gather_params(shards, mesh)
    y = tt.forward(weights, cfg, ids[mine], pos[mine], seg[mine], remat=remat, gather_layer=gather)
    y.square().sum().backward()
    sharding.sync_grads([p for _, p in param_leaves(shards)], sharding.leaf_specs(shards), mesh)
    tt.forward(full, cfg, ids, pos, seg, remat=remat).square().sum().backward()
    # each rank's slice of the full pass's gradient, against the shard's
    want = shard_params(_grads(full), mesh)
    err = max((a.grad - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
              for (_, a), (_, b) in zip(param_leaves(shards), param_leaves(want)))
    torch.save({"calls": calls, "layers_sliced": weights["layers"]["wq"].shape[1], "err": err},
               f"{out}/rank{rank}.pt")


def _grads(tree: dict) -> dict:
    return {k: _grads(v) if isinstance(v, dict) else v.grad for k, v in tree.items()}


# -- tests --------------------------------------------------------------------


@pytest.mark.parametrize("n,tp,cp,pp", [(8, 2, 2, None), (4, None, 2, None), (8, None, 8, None), (8, 1, 1, 2),
                                        (6, 3, None, None)])
def test_infer_mesh_shape_matches_jax(n, tp, cp, pp):
    from pipelinerl_tpu.parallel.mesh import infer_mesh_shape as j_infer

    assert infer_mesh_shape(n, tp=tp, cp=cp, pp=pp) == j_infer(n, tp=tp, cp=cp, pp=pp)


def test_infer_mesh_shape_refuses_like_jax():
    from pipelinerl_tpu.parallel.mesh import infer_mesh_shape as j_infer

    with pytest.raises(ValueError):
        j_infer(6, cp=4)
    with pytest.raises(ValueError):
        infer_mesh_shape(6, cp=4)


@pytest.mark.parametrize("bias,qk_norm,value_head,tied", [(False, False, False, False), (True, False, True, False),
                                                          (True, True, False, True)])
def test_param_partition_specs_match_jax(bias, qk_norm, value_head, tied):
    import jax

    from pipelinerl_tpu.models.transformer import ModelConfig, init_params, init_value_head
    from pipelinerl_tpu.parallel import param_partition_specs as j_specs

    cfg = ModelConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2,
                      num_kv_heads=1, attention_bias=bias, qk_norm=qk_norm, tie_word_embeddings=tied)
    params = init_params(jax.random.key(0), cfg)
    if value_head:
        params["value_head"] = init_value_head(jax.random.key(1), cfg)
    theirs = j_specs(params)
    ours = param_partition_specs(params)

    def as_tuples(tree):
        return {k: as_tuples(v) if isinstance(v, dict) else tuple(v) for k, v in tree.items()}

    assert ours == as_tuples(theirs)


@pytest.mark.parametrize("dp,cp", [(2, 1), (2, 2), (1, 2)])
def test_shard_unshard_round_trip(tmp_path, dp, cp):
    """Every leaf with a dp dim is cut dp ways along it, the rest stay
    whole; ``unshard_params`` gives the original leaves back bit for bit
    on every rank."""
    world("_rank_round_trip", dp * cp, dp=dp, cp=cp, out=str(tmp_path))
    for rank in range(dp * cp):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got["same"]
        assert got["sizes"]["layers.wq"] == (2, 32 // dp, 32)
        assert got["sizes"]["layers.wo"] == (2, 32, 32 // dp)
        assert got["sizes"]["embed"] == (128 // dp, 32)
        assert got["sizes"]["value_head.w"] == (32 // dp, 1)
        assert got["sizes"]["layers.ln1"] == (2, 32) and got["sizes"]["final_norm"] == (32,)


def test_shard_batch_rows_and_halo():
    """``P("dp", "cp")`` rows and slices, each slice with its successor's
    first column (labels -100 past the row's end)."""

    class Mesh:  # a (2, 2) mesh seen from rank 3 (dp 1, cp 1)
        mesh_dim_names = ("dp", "cp")

        def size(self, dim=None):
            return 2 if dim is not None else 4

        def get_local_rank(self, name):
            return 1

    batch = {"input_ids": np.arange(4 * 8).reshape(4, 8), "labels": np.arange(4 * 8).reshape(4, 8)}
    got = shard_batch(batch, Mesh())
    np.testing.assert_array_equal(got["input_ids"], np.array([[20, 21, 22, 23, 0], [28, 29, 30, 31, 0]]))
    np.testing.assert_array_equal(got["labels"][:, -1], [-100, -100])


@pytest.mark.parametrize("policy", ["reinforce", "gspo"])
def test_sharded_step_matches_jax(tmp_path, policy):
    """One sharded step of the tiny fp32 model on dp 2 x cp 2 gloo ranks
    against JAX's sharded step on a (2, 2) mesh of virtual CPU devices: the
    loss, the grad norm and every updated param within 1e-5 relative (the
    params also 1e-5 absolute, ``STEP_ATOL``)."""
    import jax
    import jax.numpy as jnp
    import optax

    from pipelinerl_tpu.parallel import make_mesh as j_mesh
    from pipelinerl_tpu.parallel import make_sharded_train_step as j_step
    from pipelinerl_tpu.parallel import shard_batch as j_shard_batch
    from pipelinerl_tpu.parallel import shard_params as j_shard_params
    from pipelinerl_tpu.train.rl_loss import RLLossConfig as JLossConfig

    cfg, params = jax_tiny()
    batch = tiny_batch(2, 32, np.random.default_rng(0))
    torch.save({"params": params, "batch": batch}, tmp_path / "data.pt")
    world("_rank_step", 4, dp=2, cp=2, data=str(tmp_path / "data.pt"), out=str(tmp_path), policy=policy)
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)

    mesh = j_mesh(n_devices=4, cp=2)
    optimizer = optax.adamw(1e-3)
    step = j_step(cfg, JLossConfig(policy_loss=policy, batch_size=2, max_segments=4), optimizer, max_step=10,
                  remat=False)
    sharded = j_shard_params(jax.tree.map(jnp.asarray, params), mesh)
    opt_state = jax.jit(optimizer.init)(sharded)
    with mesh:
        new, _, loss, metrics = step(sharded, opt_state, j_shard_batch(batch, mesh), jnp.zeros(()),
                                     jnp.asarray(0.0))
    np.testing.assert_allclose(got["loss"], float(loss), rtol=STEP_RTOL)
    np.testing.assert_allclose(got["grad_norm"], float(metrics["grad_norm"]), rtol=STEP_RTOL)
    flat = dict(param_leaves(jax.tree.map(np.asarray, new)))
    assert sorted(flat) == sorted(got["params"])
    for name, ref in flat.items():
        np.testing.assert_allclose(got["params"][name], ref, rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=name)


@pytest.mark.parametrize("remat", [True, False])
def test_layers_gathered_one_at_a_time(tmp_path, remat):
    """Under dp 2 the forward gathers each layer inside its remat region: one
    gather a layer, and one more in the backward under remat; the top
    leaves' gather leaves the layers sliced; each rank's gradient is its
    slice of the full pass's, within 1e-5 relative."""
    cfg, params = jax_tiny()
    torch.save({"params": params, "batch": tiny_batch(2, 32, np.random.default_rng(1))}, tmp_path / "data.pt")
    world("_rank_layer_gather", 2, data=str(tmp_path / "data.pt"), out=str(tmp_path), remat=remat)
    for rank in range(2):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got["calls"] == [(32 // 2, 32)] * (TINY["num_layers"] * (2 if remat else 1))
        assert got["layers_sliced"] == 32 // 2
        assert got["err"] <= STEP_RTOL
