"""The port's context-parallel attention and loss against the JAX package's:
``make_cp_attention`` at cp 2 and 4 on four gloo ranks against JAX's on a
mesh of four virtual CPU devices (forward and the gradients of q, k and v),
and ``rl_loss`` on cp slices against JAX's unsharded ``rl_loss`` with
segments that cross the slices."""

from pathlib import Path

import numpy as np
import pytest
import torch

from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.parallel import make_mesh, shard_batch
from pipelinerl_tpu_torch.parallel.collectives import reduce_
from pipelinerl_tpu_torch.parallel.cp_attention import make_cp_attention
from pipelinerl_tpu_torch.parallel.mesh import axis_group, world_group
from pipelinerl_tpu_torch.parallel.multihost import run_world
from pipelinerl_tpu_torch.parallel.sharding import leaf_specs, sync_grads
from pipelinerl_tpu_torch.parallel.train_step import batch_tensors
from pipelinerl_tpu_torch.train.rl_loss import RLLossConfig, rl_loss
from pipelinerl_tpu_torch.train.trainer import param_leaves

torch.set_num_threads(1)
HERE = str(Path(__file__).resolve().parent)
ATTN_ATOL = 3e-5  # JAX's tests/test_cp_attention.py:71
LOSS_RTOL = 2e-5  # fp32, JAX's test_cp_rl_loss_4k_parity
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
B, L, H, K, DH = 2, 1024, 4, 2, 16
TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2)


def world(target: str, n: int, **kwargs) -> None:
    run_world(f"test_torch_cp_attention:{target}", n, kwargs, timeout=120.0, pythonpath=[HERE])


def attn_inputs(seed: int = 3) -> dict[str, np.ndarray]:
    """JAX's ``_rand_packed`` (7 sorted segments a row) and a weight for the
    loss ``(out * w).sum()``."""
    rng = np.random.default_rng(seed)
    return {
        "q": rng.normal(size=(B, L, H, DH)).astype(np.float32),
        "k": rng.normal(size=(B, L, K, DH)).astype(np.float32),
        "v": rng.normal(size=(B, L, K, DH)).astype(np.float32),
        "seg": np.sort(rng.integers(0, 7, (B, L)), axis=1).astype(np.int32),
        "w": rng.normal(size=(B, L, H, DH)).astype(np.float32),
    }


def _rank_attn(rank, n, cp, data, out):
    d = torch.load(data, weights_only=False)
    mesh = make_mesh(n // cp, cp)
    part = {name: torch.from_numpy(a) for name, a in shard_batch(d, mesh).items()}  # rows and slice (+ halo)
    q, k, v = (part[x][:, :-1].clone().requires_grad_(True) for x in "qkv")
    attn = make_cp_attention(mesh, num_kv_heads=K)
    o = attn(q, k, v, part["seg"][:, :-1].contiguous())
    (o * part["w"][:, :-1]).sum().backward()
    torch.save({"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}, f"{out}/rank{rank}.pt")


def _rank_loss(rank, n, data, out, policy, chunk):
    d = torch.load(data, weights_only=False)
    cfg = tt.ModelConfig(**TINY, dtype=torch.float32)
    mesh = make_mesh(1, n)
    params = tt.params_from_numpy(d["params"], cfg, "cpu")
    leaves = [p.requires_grad_(True) for _, p in param_leaves(params)]
    loss_cfg = RLLossConfig(policy_loss=policy, batch_size=4, kl_coef=0.0)
    batch = batch_tensors(shard_batch(d["batch"], mesh), "cpu")
    attn = make_cp_attention(mesh, num_kv_heads=cfg.num_kv_heads)
    loss, _ = rl_loss(params, cfg, loss_cfg, batch, 0.0, 10, 0.0, remat=False, attn_impl=attn,
                      logits_chunk=chunk, cp_group=axis_group(mesh, "cp"))
    loss.backward()
    sync_grads(leaves, leaf_specs(params), mesh)
    total = reduce_(loss.detach().clone(), world_group(mesh))
    if rank == 0:
        torch.save({"loss": float(total), "grads": {k: p.grad.numpy() for k, p in param_leaves(params)}},
                   f"{out}/rank0.pt")


@pytest.mark.parametrize("cp", [2, 4])
def test_cp_attention_matches_jax(tmp_path, cp):
    """Each rank's slice of the output and of dq, dk, dv (dk/dv after the
    gather's reduce-scatter over cp) against JAX's ``make_cp_attention`` on
    ``make_mesh(n_devices=4, cp=cp)``, within 3e-5."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pipelinerl_tpu.parallel import make_mesh as j_mesh
    from pipelinerl_tpu.parallel.cp_attention import make_cp_attention as j_cp

    d = attn_inputs()
    torch.save(d, tmp_path / "data.pt")
    world("_rank_attn", 4, cp=cp, data=str(tmp_path / "data.pt"), out=str(tmp_path))

    mesh = j_mesh(n_devices=4, cp=cp)
    attn = j_cp(mesh, num_kv_heads=K, block_kv=256)
    specs = [P("dp", "cp", None, None)] * 3 + [P("dp", "cp")]
    q, k, v, seg = (jax.device_put(jnp.asarray(d[x]), NamedSharding(mesh, s)) for x, s in zip(("q", "k", "v", "seg"),
                                                                                                   specs))
    w = jnp.asarray(d["w"])
    ref = np.asarray(jax.jit(attn)(q, k, v, seg))
    grads = jax.jit(jax.grad(lambda q, k, v: (attn(q, k, v, seg) * w).sum(), argnums=(0, 1, 2)))(q, k, v)
    ref_g = dict(zip(("dq", "dk", "dv"), map(np.asarray, grads)))
    dp, c = 4 // cp, L // cp
    for rank in range(4):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        rows = slice((rank // cp) * (B // dp), (rank // cp + 1) * (B // dp))
        cols = slice((rank % cp) * c, (rank % cp + 1) * c)
        np.testing.assert_allclose(got["out"].numpy(), ref[rows, cols], atol=ATTN_ATOL)
        for name in ("dq", "dk", "dv"):
            np.testing.assert_allclose(got[name].numpy(), ref_g[name][rows, cols], atol=ATTN_ATOL, err_msg=name)


def crossing_batch(L_row: int = 64) -> dict[str, np.ndarray]:
    """One packed row of four samples (lengths 20, 25, 13, 6) whose segments
    cross the slices of cp 2 and cp 4, built by the JAX package's packing."""
    from pipelinerl_tpu.train.advantages import populate_rl_data, prepare_rl_fields
    from pipelinerl_tpu.train.packing import pack_samples

    rng = np.random.default_rng(5)
    samples = []
    for r, n in enumerate((20, 25, 13, 6)):
        n_prompt = 3
        ids = rng.integers(1, 120, n).tolist()
        samples.append(prepare_rl_fields({
            "input_ids": ids, "labels": [-100] * n_prompt + ids[n_prompt:], "reward": float(r % 2),
            "logprobs": list(rng.normal(-1.0, 0.3, n - n_prompt)), "group_id": "g0", "rollout_index": r,
            "step_index": 0, "finished": True, "model_version": 0,
        }))
    populate_rl_data(samples, 9)
    return pack_samples(samples, L_row, 9).arrays()


@pytest.mark.parametrize("policy,cp,chunk", [("gspo", 2, None), ("gspo", 4, None), ("gspo", 2, 16),
                                             ("ppo", 4, None), ("reinforce", 2, 16)])
def test_cp_rl_loss_matches_jax(tmp_path, policy, cp, chunk):
    """The cp ranks' losses summed, and their param gradients summed over
    cp, against JAX's ``rl_loss`` and its gradient on the whole row (plain
    attention, fp32), within 2e-5 (loss) and 2e-4 / 2e-5 (gradients) as
    JAX's own cp parity test holds them. GSPO's sequence ratios need the
    segment sums of every slice; ``chunk`` runs the chunked unembed on the
    slices."""
    import jax
    import jax.numpy as jnp

    from pipelinerl_tpu.models.transformer import ModelConfig, init_params
    from pipelinerl_tpu.train.rl_loss import RLLossConfig as JLossConfig
    from pipelinerl_tpu.train.rl_loss import rl_loss as j_rl_loss

    cfg = ModelConfig(**TINY, dtype=jnp.float32)
    params = init_params(jax.random.key(0), cfg)
    batch = crossing_batch()
    torch.save({"params": jax.tree.map(np.asarray, params), "batch": batch}, tmp_path / "data.pt")
    world("_rank_loss", cp, data=str(tmp_path / "data.pt"), out=str(tmp_path), policy=policy, chunk=chunk)
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)

    def fn(p):
        loss, _ = j_rl_loss(p, cfg, JLossConfig(policy_loss=policy, batch_size=4, kl_coef=0.0),
                            {k: jnp.asarray(v) for k, v in batch.items()}, 0, 10, 0.0, remat=False)
        return loss

    loss, grads = jax.value_and_grad(fn)(params)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL, atol=2e-6)
    for name, ref in param_leaves(jax.tree.map(np.asarray, grads)):
        np.testing.assert_allclose(got["grads"][name], ref, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
