"""The port's trainer against the JAX package's: the optimizer against optax,
one ``TrainerLoop`` step on ``bandit_cpu`` in each package, gradient
accumulation, versions and weight pushes."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from pipelinerl_tpu.config import Config as JConfig
from pipelinerl_tpu.config import compose as j_compose
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.train import trainer as jtr
from pipelinerl_tpu.train.advantages import populate_rl_data, prepare_rl_fields
from pipelinerl_tpu.train.packing import pack_samples
from pipelinerl_tpu_torch.config import Config, compose
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.streams import SingleStreamSpec, StreamReader, StreamWriter
from pipelinerl_tpu_torch.train import trainer as ttr
from pipelinerl_tpu_torch.types import TrainerBatch

torch.set_num_threads(1)
EOS = 257
OPT_ATOL = 1e-6  # fp32 Adam arithmetic, the same formula in both packages

OPT_CASES = {
    "adamw_mask_warmup_clip_low": dict(num_warmup_steps=3, gradient_clipping_threshold=1e9, weight_decay=0.1),
    "adamw_clip_high": dict(num_warmup_steps=0, gradient_clipping_threshold=0.05, weight_decay=0.01),
    "cosine": dict(lr_scheduler_type="cosine", num_warmup_steps=2, max_train_steps=6,
                   gradient_clipping_threshold=0.5, weight_decay=0.05),
}


def finetune_cfg(**kw):
    return {"learning_rate": 1e-2, "optim": "adamw", "lr_scheduler_type": "constant_with_warmup",
            "max_train_steps": 100, "samples_per_step": 1, "rl": {}, "save_checkpoint_steps": 0, **kw}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case, tmp_path):
    """Five ``optimizer_step``s of the port's TrainerLoop against optax's
    chain (clip_by_global_norm, adamw with the ndim >= 2 decay mask) on the
    same fp32 params and grads: params, pre-clip grad norm and lr."""
    ft = finetune_cfg(**OPT_CASES[case])
    rng = np.random.default_rng(0)
    shapes = {"embed": (6, 4), "final_norm": (4,), "layers": {"wq": (2, 4, 4), "ln1": (2, 4), "bq": (2, 4)}}

    def tree(fn, node=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in node.items()}

    init = tree(lambda s: rng.normal(size=s).astype(np.float32))
    grads = [tree(lambda s: rng.normal(size=s).astype(np.float32) * 0.3) for _ in range(5)]

    opt, schedule = jtr.make_optimizer(JConfig({"finetune": ft}))
    jparams = jax.tree.map(jnp.asarray, init)
    state = opt.init(jparams)
    tparams = jax.tree.map(lambda a: torch.from_numpy(a.copy()), init)
    loop = ttr.TrainerLoop(Config({"finetune": ft}), tparams, None, str(tmp_path))
    for step, g in enumerate(grads):
        jg = jax.tree.map(jnp.asarray, g)
        j_norm = float(optax.global_norm(jg))
        updates, state = opt.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (_, p), (_, gt) in zip(ttr.param_leaves(tparams), ttr.param_leaves(jax.tree.map(torch.from_numpy, g))):
            p.grad = gt.clone()
        loop._has_grads = True
        loop.optimizer_step()
        assert loop.metrics.grad_norm == pytest.approx(j_norm, rel=1e-6)
        assert loop.metrics.lr == pytest.approx(float(schedule(step)), rel=1e-6, abs=1e-12)
        for (name, p), (_, ref) in zip(ttr.param_leaves(tparams), ttr.param_leaves(jparams)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=0, atol=OPT_ATOL, err_msg=name)


# a stacked layout whose two largest axes reach 128, so that Adafactor
# factors: [L, D, F] over axes 1 and 2, [F, L, D] over axes 0 and 2, the
# embedding over both; [L, D] norms and biases and the 1-D norm keep a full v
STACKED = {"embed": (160, 132), "final_norm": (132,),
           "layers": {"wq": (2, 132, 192), "ln1": (2, 132), "bq": (2, 132), "wt": (130, 3, 140)}}
FACTORED = {"embed": (0, 1), "final_norm": None, "layers.wq": (1, 2), "layers.ln1": None, "layers.bq": None,
            "layers.wt": (0, 2)}
# bf16: the same ops in the same dtypes as optax, bit for bit; fp32: the
# reductions and XLA's pow part by an ulp (the state within rtol 1e-5 and
# atol 1e-10: lion's mu cancels near 0)
LION_ADAFACTOR_ATOL = {"bfloat16": 0.0, "float32": 1e-6}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("optim", ["lion", "adafactor"])
def test_lion_and_adafactor_match_optax(optim, dtype, tmp_path):
    """Five ``optimizer_step``s of the port's TrainerLoop against the JAX
    trainer's optax chain (clip_by_global_norm, then ``optax.lion`` with the
    ndim >= 2 decay mask or ``optax.adafactor``) on the same params and
    grads, warmup 2, the clip active on some steps: params, the optimizer's
    state (lion's mu; adafactor's v_row, v_col or v), pre-clip grad norm and
    lr. Adafactor factors the dimensions optax factors."""
    ft = finetune_cfg(optim=optim, num_warmup_steps=2, gradient_clipping_threshold=3.5, weight_decay=0.1)
    rng = np.random.default_rng(1)

    def tree(fn, node=STACKED):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in node.items()}

    init = tree(lambda s: rng.normal(size=s).astype(np.float32))
    # global norms about 2.9 and 4.3 around the threshold of 3.5
    grads = [tree(lambda s: rng.normal(size=s).astype(np.float32) * scale) for scale in (0.008, 0.012, 0.008, 0.012, 0.012)]
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    opt, schedule = jtr.make_optimizer(JConfig({"finetune": ft}))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdtype), init)
    state = opt.init(jparams)
    tparams = jax.tree.map(lambda a: torch.from_numpy(a.copy()).to(tdtype), init)
    loop = ttr.TrainerLoop(Config({"finetune": ft}), tparams, None, str(tmp_path))
    leaves = dict(ttr.param_leaves(tparams))
    clipped = []
    for step, g in enumerate(grads):
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdtype), g)
        j_norm = float(optax.global_norm(jg))
        clipped.append(j_norm >= 3.5)
        updates, state = opt.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for (_, p), (_, gt) in zip(ttr.param_leaves(tparams), ttr.param_leaves(jax.tree.map(torch.from_numpy, g))):
            p.grad = gt.to(tdtype)
        loop._has_grads = True
        loop.optimizer_step()
        assert loop.metrics.grad_norm == pytest.approx(j_norm, rel=1e-6)
        assert loop.metrics.lr == pytest.approx(float(schedule(step)), rel=1e-6, abs=1e-12)
        atol = LION_ADAFACTOR_ATOL[dtype]
        for (name, p), (_, ref) in zip(ttr.param_leaves(tparams), ttr.param_leaves(jparams)):
            assert p.dtype == tdtype
            np.testing.assert_allclose(p.detach().float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=0,
                                       atol=atol, err_msg=name)
        inner = state[1][0]  # (clip state, (the optimizer's first transform, ...))
        keys = {"lion": ("mu",), "adafactor": ("v_row", "v_col", "v")}[optim]
        for key in keys:
            for name, ref in ttr.param_leaves(getattr(inner, key)):
                ours = loop.optimizer.state[leaves[name]]
                if key not in ours:  # optax keeps a (1,) placeholder where it does not use the slot
                    assert ref.shape == (1,), (name, key)
                    continue
                assert ours[key].dtype == tdtype
                np.testing.assert_allclose(ours[key].float().numpy(), np.asarray(ref.astype(jnp.float32)),
                                           rtol=1e-5 if atol else 0, atol=1e-10 if atol else 0, err_msg=f"{name} {key}")
    assert any(clipped) and not all(clipped)
    if optim == "adafactor":
        for name, p in leaves.items():
            assert ("v_row" in loop.optimizer.state[p]) == (FACTORED[name] is not None), name


@pytest.mark.parametrize("shape", [(4,), (2, 4), (2, 132, 192), (130, 3, 140), (3, 127, 500), (24, 896, 4864),
                                   (24, 4864, 896), (151936, 896), (128, 128), (5, 128, 128, 2)])
def test_factored_dims_equal_optax(shape):
    """The axes Adafactor factors over, against optax's ``_factored_dims``
    (the two largest of the whole stacked tensor, where the second largest
    reaches 128)."""
    from optax._src.factorized import _factored_dims

    from pipelinerl_tpu_torch.train.optimizers import factored_dims

    assert factored_dims(shape) == _factored_dims(shape, True, 128)


def test_checkpoint_settings(tmp_path):
    loop = ttr.TrainerLoop(Config({"finetune": finetune_cfg(save_checkpoint_steps=10)}), {"w": torch.zeros(2)},
                           None, str(tmp_path))
    assert loop.save_checkpoint_steps == 10 and loop.checkpoint_dir == tmp_path / "finetune"


def packed(seed, n=4, L=128):
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(n):
        ids = [256, *rng.integers(97, 123, 8).tolist(), 257, *rng.integers(97, 123, 3).tolist()]
        samples.append(prepare_rl_fields({
            "input_ids": ids, "labels": [-100] * 10 + ids[10:], "reward": float(rng.random()),
            "logprobs": (-rng.random(3) - 0.5).tolist(), "group_id": "g", "rollout_index": i,
            "step_index": 0, "model_version": seed, "finished": True, "finish_reason": "stop",
        }))
    populate_rl_data(samples, EOS)
    return pack_samples(samples, L, EOS)


def port_batch(jb):
    return TrainerBatch.from_msg(jb.to_msg())


OVERRIDES = ["output_dir=/unused", "finetune.save_checkpoint_steps=0"]


def test_one_trainer_step_matches_jax(tmp_path):
    """bandit_cpu in each package (JAX from compose, port from its preset),
    the same weights and packed batch: loss, pre-clip grad norm and the
    updated params. Tolerance: loss rtol 1e-5, grad norm rtol 1e-4 (fp32
    sums in another order); params atol 1e-4, 2.5 % of the 4e-3 first Adam
    step lr * g / (|g| + eps): that step barely depends on g, except where an
    entry of g is itself a near-cancellation (an embedding row of a token
    seen at a few positions) that fp32 reassociation moves by a share of
    its own size."""
    jcfg = j_compose("conf", "bandit_cpu", OVERRIDES)
    tcfg = compose("bandit_cpu", OVERRIDES)
    toy = jcfg.toy_model
    jmc = jt.ModelConfig(vocab_size=260, hidden_size=toy.hidden_size, intermediate_size=toy.intermediate_size,
                         num_layers=toy.num_layers, num_heads=toy.num_heads, num_kv_heads=toy.num_kv_heads,
                         dtype=jnp.float32)
    tmc = tt.ModelConfig(vocab_size=260, hidden_size=toy.hidden_size, intermediate_size=toy.intermediate_size,
                         num_layers=toy.num_layers, num_heads=toy.num_heads, num_kv_heads=toy.num_kv_heads,
                         dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(0), jmc)
    tparams = tt.params_from_numpy(jax.tree.map(np.asarray, jparams), tmc, "cpu")
    jloop = jtr.TrainerLoop(jcfg, jparams, jmc, str(tmp_path / "j"))
    tloop = ttr.TrainerLoop(tcfg, tparams, tmc, str(tmp_path / "t"))
    assert tloop.attn_impl == "xla" and tloop.remat is False
    batch = packed(1, L=tcfg.finetune.seq_length)
    jm = jloop.train_pass(batch)
    tm = tloop.train_pass(port_batch(batch))
    assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-5)
    for key in ("entropy", "new_logprobs", "num_output_tokens_sum"):
        assert tm[key] == pytest.approx(jm[key], rel=1e-4)
    jloop.optimizer_step()
    tloop.optimizer_step()
    assert tloop.metrics.grad_norm == pytest.approx(jloop.metrics.grad_norm, rel=1e-4)
    assert tloop.metrics.samples == jloop.metrics.samples == 4
    for (name, p), (_, ref) in zip(ttr.param_leaves(tloop.params), ttr.param_leaves(jloop.params)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-4, err_msg=name)


def small_loop(tmp_path, cb=None, **ft):
    cfg = compose("bandit_cpu", OVERRIDES + [f"finetune.{k}={v}" for k, v in ft.items()])
    mc = tt.ModelConfig(vocab_size=260, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
                        num_kv_heads=2, dtype=torch.float32)
    params = tt.init_params(torch.Generator().manual_seed(0), mc, "cpu")
    return ttr.TrainerLoop(cfg, params, mc, str(tmp_path), weight_update_cb=cb)


def test_accumulation_over_two_passes_equals_one_step(tmp_path):
    """Two passes then one step equal one pass over both rows stacked:
    the loss is normalized by the step's sample count, so gradients add.
    Gradients rtol 1e-5 (fp32 sums in another order); params atol 1e-5,
    0.25 % of the 4e-3 Adam step, for the near-cancelling entries of g."""
    a, b = packed(2, L=64), packed(3, L=64)
    two = small_loop(tmp_path / "two")
    two.train_pass(port_batch(a))
    two.train_pass(port_batch(b))
    both = {name: np.concatenate([a.arrays()[name], b.arrays()[name]]) for name in a.arrays()}
    one = small_loop(tmp_path / "one")
    one.train_pass(TrainerBatch(**both, num_sequences=8))
    for (name, p), (_, q) in zip(ttr.param_leaves(two.params), ttr.param_leaves(one.params)):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(), rtol=1e-5, atol=1e-7, err_msg=name)
    two.optimizer_step()
    one.optimizer_step()
    assert two.metrics.grad_norm == pytest.approx(one.metrics.grad_norm, rel=1e-5)
    for (name, p), (_, q) in zip(ttr.param_leaves(two.params), ttr.param_leaves(one.params)):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=0, atol=1e-5, err_msg=name)


def test_version_is_samples_and_pushes_do_not_alias(tmp_path):
    pushed = []
    loop = small_loop(tmp_path, cb=lambda params, version: pushed.append((params, version)),
                      weight_update_interval=1)
    writer = StreamWriter(SingleStreamSpec(str(tmp_path), "weight_update_request"))
    loop.maybe_push_weights(writer, force=True)
    loop.train_pass(port_batch(packed(4, L=64)))
    loop.train_pass(port_batch(packed(5, n=3, L=64)))
    loop.optimizer_step()
    assert loop.metrics.samples == 7
    assert loop.maybe_push_weights(writer)
    writer.close()
    assert [v for _, v in pushed] == [0, 7]
    msgs = list(StreamReader(SingleStreamSpec(str(tmp_path), "weight_update_request")).read_available())
    assert [m["version"] for m in msgs] == [0, 7]
    copy0, copy7 = pushed[0][0], pushed[1][0]
    trainer = dict(ttr.param_leaves(loop.params))
    for name, t in ttr.param_leaves(copy7):
        assert t.data_ptr() != trainer[name].data_ptr() and not t.requires_grad
        assert torch.equal(t, trainer[name].detach())
    before = {name: t.clone() for name, t in ttr.param_leaves(copy7)}
    loop.train_pass(port_batch(packed(6, L=64)))
    loop.optimizer_step()  # updates the trainer's tensors in place
    assert all(torch.equal(t, before[name]) for name, t in ttr.param_leaves(copy7))
    assert not all(torch.equal(t, trainer[name].detach()) for name, t in ttr.param_leaves(copy0))
