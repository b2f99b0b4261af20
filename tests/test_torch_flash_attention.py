"""``attn_impl="flash"`` of the port (routed to the GQA autograd function)
against the JAX package's splash kernel in interpret mode: output and
gradients, in fp32 (mirrors tests/test_flash_attention.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.ops.flash_attention import mha_packed_flash as j_flash
from pipelinerl_tpu_torch.ops.flash_attention import mha_packed_flash as t_flash

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 both sides; sums in another order


@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
def test_flash_route_matches_splash(H, K):
    rng = np.random.default_rng(H + K)
    B, L, Dh = 1, 256, 32
    q = rng.normal(size=(B, L, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, L, K, Dh)).astype(np.float32)
    v = rng.normal(size=(B, L, K, Dh)).astype(np.float32)
    do = rng.normal(size=(B, L, H, Dh)).astype(np.float32)
    seg = np.zeros((B, L), np.int32)
    seg[:, 100:] = 1
    seg[:, 200:] = 2

    def jf(q_, k_, v_):
        return j_flash(q_, k_, v_, jnp.asarray(seg), interpret=True)

    j_out, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_grads = vjp(jnp.asarray(do))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = t_flash(*leaves, torch.from_numpy(seg))
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    for leaf, ref in zip(leaves, j_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), **TOL)
