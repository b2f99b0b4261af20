"""The port's vision tower and multimodal rope against the JAX package's:
the host geometry (``vision_meta``, ``permute_patches``,
``prepare_vision_inputs``) and ``mrope_positions`` exactly, ``mrope_cos_sin``
to fp32 rounding, and ``vision_forward`` and a spliced language ``forward``
in fp32 within 1e-5, over one image, several images, a two-frame grid and a
padded patch bucket, on the same weights (carried through numpy)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pipelinerl_tpu.models import mrope as jmrope
from pipelinerl_tpu.models import transformer as jt
from pipelinerl_tpu.models import vision as jv
from pipelinerl_tpu_torch.models import mrope as tmrope
from pipelinerl_tpu_torch.models import transformer as tt
from pipelinerl_tpu_torch.models import vision as tv

torch.set_num_threads(1)
IMG = 9
VKW = dict(hidden_size=16, intermediate_size=32, num_heads=2, depth=3, out_hidden_size=32, patch_size=2,
           temporal_patch_size=1, spatial_merge_size=2, window_size=8, fullatt_block_indexes=(1,))
MKW = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           mrope_section=(2, 1, 1), image_token_id=IMG)
ATOL = 1e-5  # fp32 on both sides, sums in another order
# one image; three images of other shapes (windows cut at the edges); a
# two-frame grid; and one image in a bucket of twice its merged tokens
GRIDS = {
    "single": [(1, 4, 4)],
    "multi": [(1, 4, 4), (1, 6, 10), (1, 2, 8)],
    "frames": [(2, 6, 4)],
    "padded": [(1, 6, 6)],
}
BUCKETS = {"single": (4,), "multi": (64,), "frames": (12,), "padded": (18,)}


@pytest.fixture(scope="module")
def towers():
    jcfg = jv.VisionConfig(dtype=jnp.float32, **VKW)
    jparams = jv.init_vision_params(jax.random.key(1), jcfg)
    tcfg = tv.VisionConfig(dtype=torch.float32, **VKW)
    mcfg = tt.ModelConfig(dtype=torch.float32, **MKW)
    return jparams, jcfg, tt.params_from_numpy(jax.tree.map(np.asarray, jparams), mcfg, "cpu"), tcfg


def pixels(grid, patch_dim, seed):
    n = sum(int(np.prod(g)) for g in grid)
    return np.random.default_rng(seed).normal(size=(n, patch_dim)).astype(np.float32) * 0.5


@pytest.mark.parametrize("name", GRIDS)
def test_host_geometry_equals_jax(towers, name):
    _, jcfg, _, tcfg = towers
    grid = np.asarray(GRIDS[name])
    jm, tm = jv.vision_meta(grid, jcfg), tv.vision_meta(grid, tcfg)
    for field in ("perm", "inv_perm", "hw", "win_seg", "full_seg"):
        np.testing.assert_array_equal(getattr(tm, field), getattr(jm, field), err_msg=field)
    assert (tm.n_patches, tm.n_tokens) == (jm.n_patches, jm.n_tokens)
    pix = pixels(GRIDS[name], tcfg.patch_dim, 0)
    np.testing.assert_array_equal(tv.permute_patches(pix, tm, tcfg), jv.permute_patches(pix, jm, jcfg))
    jin = jv.prepare_vision_inputs(pix, grid, jcfg, BUCKETS[name])
    tin = tv.prepare_vision_inputs(pix, grid, tcfg, BUCKETS[name])
    assert sorted(tin) == sorted(jin)
    for k in jin:
        np.testing.assert_array_equal(np.asarray(tin[k]), np.asarray(jin[k]), err_msg=k)


@pytest.mark.parametrize("case", [
    ([5, 6, IMG, IMG, IMG, IMG, 7, 8], [(1, 4, 4)]),
    ([IMG] * 4 + [1] + [IMG] * 6 + [2, 3], [(1, 4, 4), (1, 4, 6)]),
    ([3] + [IMG] * 12 + [4], [(2, 4, 6)]),
    ([1, 2, 3], None),
])
def test_mrope_positions_equal_jax(case):
    ids, grid = case
    grid = None if grid is None else np.asarray(grid)
    for video in (False, True):
        jpos, jdelta = jmrope.mrope_positions(ids, grid, IMG, 2, tokens_per_second=2, video=video)
        tpos, tdelta = tmrope.mrope_positions(ids, grid, IMG, 2, tokens_per_second=2, video=video)
        np.testing.assert_array_equal(tpos, jpos)
        assert tdelta == jdelta


@pytest.mark.parametrize("section,head_dim", [((2, 1, 1), 8), ((16, 24, 24), 128)])
def test_mrope_cos_sin_equals_jax(section, head_dim):
    ids = [5] + [IMG] * 24 + [6, 7]
    pos, _ = tmrope.mrope_positions(ids, np.asarray([(1, 8, 12)]), IMG, 2)
    pos = np.stack([pos, pos + 3], axis=1)  # [3, 2, P]: two rows
    jc, js = jt.mrope_cos_sin(jnp.asarray(pos), head_dim, 1e6, section)
    tc, ts = tt.mrope_cos_sin(torch.from_numpy(pos), head_dim, 1e6, section)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)
    # text rows (three equal rows) are the standard rope
    flat = np.broadcast_to(np.arange(10), (3, 1, 10)).copy()
    c3, s3 = tt.mrope_cos_sin(torch.from_numpy(flat), head_dim, 1e6, section)
    c1, s1 = tt.rope_cos_sin(torch.arange(10)[None], head_dim, 1e6)
    assert torch.equal(c3, c1) and torch.equal(s3, s1)


def tower_inputs(vin):
    return [jnp.asarray(vin[k]) for k in ("patches", "hw", "win_seg", "full_seg", "inv_perm")]


@pytest.mark.parametrize("name", GRIDS)
def test_vision_forward_equals_jax(towers, name):
    jparams, jcfg, tparams, tcfg = towers
    grid = np.asarray(GRIDS[name])
    pix = pixels(GRIDS[name], tcfg.patch_dim, 3)
    vin = tv.prepare_vision_inputs(pix, grid, tcfg, BUCKETS[name])
    want = np.asarray(jv.vision_forward(jparams, jcfg, *tower_inputs(vin)))
    got = tv.vision_forward(tparams, tcfg, **tv.vision_inputs_to(vin, "cpu"))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the real tokens do not depend on the bucket's pad patches
    n = vin["n_tokens"]
    direct = tv.encode_images(tparams, tcfg, pix, grid)
    np.testing.assert_allclose(direct.numpy(), got[:n].numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(direct.numpy(), np.asarray(jv.encode_images(jparams, jcfg, pix, grid)), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("name", GRIDS)
def test_spliced_forward_equals_jax(towers, name):
    """A VLM row: text, each image's placeholders, text between, padding
    after; mrope rows from ``mrope_positions``; the tower's merged tokens
    spliced at the placeholders. Logits within 1e-5, also with return_kv."""
    jparams_v, jcfg_v, tparams_v, tcfg_v = towers
    jcfg = jt.ModelConfig(dtype=jnp.float32, **MKW)
    tcfg = tt.ModelConfig(dtype=torch.float32, **MKW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    grid = GRIDS[name]
    ids = [5, 6]
    for i, (t, h, w) in enumerate(grid):
        ids += [IMG] * (t * h * w // 4) + [10 + i]
    n, L = len(ids), len(ids) + 5
    pos3, _ = tmrope.mrope_positions(ids, np.asarray(grid), IMG, 2)
    pos = np.zeros((3, 1, L), np.int64)
    pos[:, 0, :n] = pos3
    pos[:, 0, n:] = pos3.max() + 1 + np.arange(L - n)
    row = np.zeros((1, L), np.int64)
    row[0, :n] = ids
    pix = pixels(grid, tcfg_v.patch_dim, 4)
    vin = tv.prepare_vision_inputs(pix, np.asarray(grid), tcfg_v, BUCKETS[name])
    jemb = jv.vision_forward(jparams_v, jcfg_v, *tower_inputs(vin))
    want, (jk, jv_) = jt.forward(jparams, jcfg, jnp.asarray(row, jnp.int32), jnp.asarray(pos, jnp.int32),
                                 jnp.zeros((1, L), jnp.int32), return_kv=True, image_embeds=jemb[None],
                                 image_mask=jnp.asarray(row == IMG))
    temb = tv.vision_forward(tparams_v, tcfg_v, **tv.vision_inputs_to(vin, "cpu"))
    got, (tk, tv_) = tt.forward(tparams, tcfg, torch.from_numpy(row), torch.from_numpy(pos),
                                torch.zeros((1, L), dtype=torch.int32), return_kv=True, image_embeds=temb[None],
                                image_mask=torch.from_numpy(row == IMG))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tv_.numpy(), np.asarray(jv_), rtol=0, atol=ATOL)
